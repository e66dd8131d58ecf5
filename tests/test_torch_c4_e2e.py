"""The port's e2e C4 training step against JAX's ``make_e2e_train_step``:
e2e Faster and Mask R-CNN R-50-C4, fp32, the host-blob schema.

The case (two 64x128 images, JAX's uniforms injected, pre 200 / post 64,
32 rois) and the comparison of the sampled sets are those of
tests/torch_e2e_case.py. Its step-0 gradient norm passes the schedule's
clip, so both sides run without the clip. Tolerances, as
tests/test_torch_e2e_step.py: the step-0 sample's labels, validity and gt
indices equal row for row and its rois within 2e-3 px; the losses of two
steps rtol 1e-4, atol 1e-5; the step-0 gradient per trainable leaf
||d|| <= 1e-3 * ||g|| and cosine >= 0.9999.
"""

import numpy as np
import pytest
import torch

from tests import torch_e2e_case as case
from tests.test_torch_train import _params

FASTER, MASK = "e2e_faster_rcnn_R-50-C4_2x", "e2e_mask_rcnn_R-50-C4_2x"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("preset,train_mask", [(FASTER, False), (MASK, True)],
                         ids=["faster", "mask"])
def test_c4_e2e_step_matches_jax(preset, train_mask):
    """e2e C4 against JAX with JAX's uniforms: the step-0 sample row for
    row, the losses of two steps, the step-0 gradient in norm and cosine."""
    cfg, pcfg = case.cfgs(preset, compute_dtype="float32")
    params = _params(cfg)
    batch = case.make_batch(7, train_mask, device_input=False)
    jax_metrics, jax_grads, _ = case.run_jax(cfg, params, batch, train_mask, False, 2,
                                             case.SOLVER_NO_CLIP)
    port_metrics, _ = case.run_port(pcfg, params, batch, train_mask, False, 2,
                                    case.PSOLVER_NO_CLIP)
    _, _, sampled, port_grads, images = case.port_losses(pcfg, params, batch, train_mask, False)
    for i, js in enumerate(case.jax_sampled(cfg, params, images, batch)):
        np.testing.assert_array_equal(sampled.labels[i].numpy(), js.labels)
        np.testing.assert_array_equal(sampled.valid[i].numpy(), js.valid)
        np.testing.assert_array_equal(sampled.gt_inds[i].numpy()[js.valid],
                                      js.gt_inds[js.valid])
        np.testing.assert_allclose(sampled.rois[i].numpy(), js.rois, rtol=0, atol=case.ROI_ATOL)
        assert js.valid.sum() > 8 and (js.labels > 0).sum() > 0
    keys = ["loss", "loss_cls", "loss_bbox", "loss_rpn_cls", "loss_rpn_bbox", "accuracy"]
    keys += ["loss_mask"] if train_mask else []
    for got, exp in zip(port_metrics, jax_metrics):
        for k in keys:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5, err_msg=k)
    checked = 0
    for k, g in port_grads.items():
        e = jax_grads[k].numpy().astype(np.float64).ravel()
        if not np.abs(e).any():
            assert not g.abs().max() > 0, k
            continue
        a = g.numpy().astype(np.float64).ravel()
        assert np.linalg.norm(a - e) <= 1e-3 * np.linalg.norm(e), k
        assert a @ e / (np.linalg.norm(a) * np.linalg.norm(e)) >= 0.9999, k
        checked += 1
    assert "rpn_cls_logits_w" in port_grads and checked >= 50
