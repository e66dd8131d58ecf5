"""The port's e2e training step against JAX's ``make_e2e_train_step``:
e2e Faster R-CNN and e2e Mask R-CNN, fp32, the host-blob schema.

The case and the comparison of the sampled sets are described in
tests/torch_e2e_case.py. Tolerances, fp32:
  * losses and accuracy of both steps: rtol 1e-4, atol 1e-5 (as
    tests/test_torch_train.py);
  * the step-0 sample: labels, validity and gt indices equal row for row,
    rois atol 2e-3 px;
  * every trainable leaf's step-0 gradient: ||d|| <= 1e-3 * ||g_leaf|| and
    cosine >= 0.9999; params after 2 steps: the same bounds on p2 - p0, plus
    3 ulp of the leaf's largest value per element for the fp32 rounding of
    the stored params; frozen leaves stay put. A bound on the norm and not
    on each element: the mask head's weight gradients are sums over every
    mask pixel of sigmoid(x) - t, which cancel, and their fp32 rounding
    follows oneDNN's blocking for the thread count. Measured in the
    device-input case: every mask leaf within 4.8e-4 in norm, while single
    elements of conv5_mask_w move by up to 2.9e-3 of the leaf's largest
    with one torch thread (3e-4 with four).
"""

import numpy as np
import pytest
import torch

from tests import torch_e2e_case as case
from tests.test_torch_train import _params
from detectorch_tpu_torch.checkpoint.convert import params_from_jax

FASTER, MASK = "e2e_faster_rcnn_R-50-FPN_2x", "e2e_mask_rcnn_R-50-FPN_2x"
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_case(preset, train_mask, device_input, seed):
    cfg, pcfg = case.cfgs(preset, compute_dtype="float32")
    params = _params(cfg)
    batch = case.make_batch(seed, train_mask, device_input)
    jax_metrics, jax_grads, jax_params = case.run_jax(cfg, params, batch, train_mask,
                                                      device_input, STEPS)
    port_metrics, port_params = case.run_port(pcfg, params, batch, train_mask, device_input,
                                              STEPS)
    _, _, sampled, port_grads, images = case.port_losses(pcfg, params, batch, train_mask,
                                                         device_input)
    return dict(params=params, train_mask=train_mask, jax_metrics=jax_metrics,
                jax_grads=jax_grads, jax_params=jax_params, port_metrics=port_metrics,
                port_params=port_params, port_grads=port_grads, sampled=sampled,
                jax_sampled=case.jax_sampled(cfg, params, images, batch))


@pytest.fixture(scope="module", params=[(FASTER, False), (MASK, True)], ids=["faster", "mask"])
def e2e_run(request):
    preset, train_mask = request.param
    return run_case(preset, train_mask, False, seed=1)


def check_losses(run):
    keys = ["loss", "loss_cls", "loss_bbox", "loss_rpn_cls", "loss_rpn_bbox", "accuracy", "lr"]
    keys += ["loss_mask"] if run["train_mask"] else []
    assert set(keys) <= set(run["port_metrics"][0])
    for got, exp in zip(run["port_metrics"], run["jax_metrics"]):
        for k in keys:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=1e-5, err_msg=k)
    first = run["jax_metrics"][0]
    assert first["loss_rpn_bbox"] > 1e-3 and first["loss_bbox"] > 1e-3


def check_sample(run):
    s = run["sampled"]
    for i, e in enumerate(run["jax_sampled"]):
        np.testing.assert_array_equal(s.labels[i].numpy(), e.labels)
        np.testing.assert_array_equal(s.valid[i].numpy(), e.valid)
        np.testing.assert_array_equal(s.gt_inds[i].numpy()[e.valid], e.gt_inds[e.valid])
        np.testing.assert_allclose(s.rois[i].numpy(), e.rois, rtol=0, atol=case.ROI_ATOL)
        assert (e.labels > 0).sum() >= 2 and e.valid.sum() == 32


def _compare_norm(name, got, exp, rel=1e-3, cos_min=0.9999, floor=0.0):
    """||got - exp|| <= rel * ||exp|| + floor * sqrt(size), cosine >= cos_min."""
    got = np.asarray(got, np.float64).ravel()
    exp = np.asarray(exp, np.float64).ravel()
    norm = np.linalg.norm(exp)
    if norm == 0:
        assert not got.any(), name
        return
    err = np.linalg.norm(got - exp)
    assert err <= rel * norm + floor * np.sqrt(exp.size), (name, err / norm)
    assert got @ exp / (np.linalg.norm(got) * norm) >= cos_min, name


def check_gradients(run):
    got, exp = run["port_grads"], run["jax_grads"]
    trainable = {k for k in exp if not (k.endswith("_bn_s") or k.endswith("_bn_b")
                                        or k.startswith(("conv1", "res_conv1", "res2")))}
    assert set(got) == trainable
    for k in sorted(trainable):
        _compare_norm(k, got[k].numpy(), exp[k].numpy())
    # the RPN head learns in e2e training, and so does the whole trunk
    for k in ("conv_rpn_fpn2_w", "rpn_cls_logits_fpn2_w", "rpn_bbox_pred_fpn2_w",
              "fpn_res2_2_sum_w", "res3_0_branch2a_w", "fc6_w"):
        assert exp[k].abs().max() > 0, k


def check_params(run):
    p0 = params_from_jax(run["params"])
    got, exp = run["port_params"], run["jax_params"]
    assert set(got) == set(exp)
    for k in sorted(exp):
        if k in run["port_grads"]:
            ulps = 3 * np.spacing(p0[k].abs().max().numpy())
            _compare_norm(k, (got[k] - p0[k]).numpy(), (exp[k] - p0[k]).numpy(), floor=ulps)
        else:  # frozen
            assert torch.equal(got[k], p0[k]) and torch.equal(exp[k], p0[k]), k


def test_e2e_step_losses_match_jax(e2e_run):
    check_losses(e2e_run)


def test_e2e_step_sample_matches_jax(e2e_run):
    check_sample(e2e_run)


def test_e2e_step_gradients_match_jax(e2e_run):
    check_gradients(e2e_run)


def test_e2e_params_after_two_steps_match_jax(e2e_run):
    check_params(e2e_run)
