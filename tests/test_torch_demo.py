"""The port's demo (``detectorch_tpu_torch/tools/demo.py``) against the JAX
package's demo steps, on the CPU at a reduced test scale.

The JAX tool (``tools/demo.py``) loads the image, runs
``InferenceEngine.run_image`` and renders with ``utils.vis``. Here
``run_demo`` runs the port's steps on a 56x84 PNG (resized to a 64x96 blob),
for e2e_mask_rcnn_R-50-FPN_2x and for e2e_keypoint_rcnn_R-50-FPN_1x with a
small keypoint head (KeypointConfig(2, 32)): fp32, RPN 100 -> 20, 5
detections (+ 8 tie slots) at score_thresh 0, one torch thread; JAX's FPN
RoIAlign is its exact gather. The weights are init_params(seed 0) with one
confident class (its cls_score bias 6, so that detections pass the demo's
threshold), a +-3 mask_fcn_logits_b bias per class (random mask logits sit
on the 0.5 threshold) and a +3 kps_score_lowres_b bias (keypoint logits
above vis's kp_thresh of 2, so that skeletons are drawn).

Tolerances, those of the engine tests (tests/test_torch_engine.py,
tests/test_torch_kp_engine.py): the same detections, classes in score
order, boxes within rtol 1e-4 / atol 1e-3, scores within 1e-6, equal mask
RLEs; keypoints within 1e-3 px except at most 2% at a near-tied heatmap
argmax. The file the port writes equals, pixel for pixel, JAX's
``vis_one_image`` rendered on the port's detections. ``checked`` around the
small inference function agrees with JAX's ``checked`` around JAX's.
"""

import importlib.util
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.data.transforms import load_image_rgb as jload_image_rgb
from detectorch_tpu.eval import engine as jengine
from detectorch_tpu.models import detector as jdet
from detectorch_tpu.utils import debug as jdebug
from detectorch_tpu.utils import vis as jvis
from detectorch_tpu_torch import config as torch_config
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models import detector as tdet
from detectorch_tpu_torch.tools import demo
from detectorch_tpu_torch.utils import debug as tdebug
from tests.torch_configs import both_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK, KP = "e2e_mask_rcnn_R-50-FPN_2x", "e2e_keypoint_rcnn_R-50-FPN_1x"
THRESH = 0.3
CONFIDENT = {MASK: 18, KP: 1}  # horse (its mask bias +3); person


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(preset):
    def build(config):
        cfg = config.PRESETS[preset].replace(
            compute_dtype="float32", use_pallas_roi_align=False,
            rpn=config.RPNConfig(pre_nms_top_n=100, post_nms_top_n=20))
        if preset == KP:
            cfg = cfg.replace(keypoint=config.KeypointConfig(num_convs=2, conv_dim=32))
        return cfg
    return build


CONFIGS = {p: both_configs(_small(p)) for p in (MASK, KP)}
TCFG, PTCFG = both_configs(lambda c: c.TestConfig(
    target_size=64, max_size=96, detections_per_img=5, score_thresh=0.0, exact_blob_dims=True))


def _weights(preset):
    """JAX-layout numpy params of the test's configuration (see the module
    docstring for the biases)."""
    cfg = CONFIGS[preset][0]
    params = {k: np.array(v) for k, v in jdet.init_params(cfg, seed=0).items()}
    params["cls_score_b"][CONFIDENT[preset]] = 6.0
    if cfg.use_mask:
        params["mask_fcn_logits_b"][0::2], params["mask_fcn_logits_b"][1::2] = 3.0, -3.0
    if cfg.keypoint is not None:
        params["kps_score_lowres_b"][:] = 3.0
    return params


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    """A 56x84 PNG of noise with two flat rectangles."""
    rng = np.random.RandomState(11)
    im = rng.randint(0, 256, (56, 84, 3)).astype(np.uint8)
    im[8:40, 10:50] = (200, 40, 90)
    im[20:50, 55:80] = (30, 160, 220)
    path = str(tmp_path_factory.mktemp("demo") / "input.png")
    cv2.imwrite(path, im)
    return path


def _check_detections(got, exp, preset):
    assert len(got["scores"]) == len(exp["scores"]) >= 5
    order_g, order_e = np.argsort(-got["scores"], kind="stable"), np.argsort(-exp["scores"],
                                                                           kind="stable")
    np.testing.assert_array_equal(got["classes"][order_g], exp["classes"][order_e])
    np.testing.assert_allclose(got["boxes"][order_g], exp["boxes"][order_e], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["scores"][order_g], exp["scores"][order_e], rtol=1e-4,
                               atol=1e-6)
    assert (got["scores"] >= THRESH).any() and (got["classes"] == CONFIDENT[preset]).any()
    if preset == MASK:
        assert [got["rles"][i] for i in order_g] == [exp["rles"][i] for i in order_e]
        assert "keypoints" not in got
    else:
        a, b = got["keypoints"][order_g], exp["keypoints"][order_e]
        far = (np.abs(a[..., :2] - b[..., :2]) > 1e-3).any(axis=-1)
        assert far.sum() <= 0.02 * far.size, (far.sum(), far.size)
        np.testing.assert_allclose(a[..., 2][~far], b[..., 2][~far], rtol=1e-4, atol=1e-4)
        assert (a[..., 2] > 2.0).any()  # vis's kp_thresh: a skeleton is drawn
        assert "rles" not in got


@pytest.mark.parametrize("preset", [MASK, KP], ids=["mask", "keypoint"])
def test_run_demo_matches_jax_demo_steps(preset, image_path, tmp_path, capsys):
    jcfg, pcfg = CONFIGS[preset]
    params = _weights(preset)
    out = str(tmp_path / "demo.png")
    got = demo.run_demo(pcfg, PTCFG, params_from_jax(params), image_path, out, THRESH,
                        device="cpu")
    lines = capsys.readouterr().out.splitlines()
    n = int((got["scores"] >= THRESH).sum())
    assert lines == ["running inference...",
                     f"{len(got['scores'])} detections ({n} above {THRESH})", f"wrote {out}"]

    im = jload_image_rgb(image_path)
    exp = jengine.InferenceEngine(jcfg, TCFG, params).run_image(im)
    _check_detections(got, exp, preset)

    # the file: JAX's vis_one_image on the port's detections, pixel for pixel
    ref = str(tmp_path / "jax_vis.png")
    drawn = jvis.vis_one_image(im, got["boxes"], got["scores"], got["classes"], got.get("rles"),
                               got.get("keypoints"), thresh=THRESH, output_path=ref)
    written = cv2.imread(out)
    assert written.shape == im.shape
    assert np.array_equal(written, cv2.imread(ref))
    assert np.array_equal(written[:, :, ::-1], drawn) and (drawn != im).any()


def test_run_demo_matplotlib_backend(image_path, tmp_path, capsys):
    """--backend matplotlib: <stem>.<ext> beside --out, as JAX's tool saves."""
    _, pcfg = CONFIGS[MASK]
    params = _weights(MASK)
    got = demo.run_demo(pcfg, PTCFG, params_from_jax(params), image_path,
                        str(tmp_path / "vis.png"), THRESH, backend="matplotlib", device="cpu")
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {tmp_path / 'vis.png'}"
    exp_dir = tmp_path / "jax"
    jvis.vis_one_image_matplotlib(jload_image_rgb(image_path), got["boxes"], got["scores"],
                                  got["classes"], got["rles"], None, thresh=THRESH,
                                  output_dir=str(exp_dir), im_name="vis", ext="png")
    assert np.array_equal(cv2.imread(str(tmp_path / "vis.png"), cv2.IMREAD_UNCHANGED),
                          cv2.imread(str(exp_dir / "vis.png"), cv2.IMREAD_UNCHANGED))


def _jax_demo_main():
    spec = importlib.util.spec_from_file_location("jax_demo", os.path.join(REPO, "tools",
                                                                           "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("preset", ["fast_rcnn_R-50-FPN_2x", "fast_rcnn_R-50-C4_2x"])
def test_main_refuses_a_fast_rcnn_preset_as_jax_does(preset, image_path, monkeypatch):
    argv = ["--image", image_path, "--preset", preset]
    monkeypatch.setattr("sys.argv", ["demo.py", *argv])
    with pytest.raises(SystemExit) as jax_exit:
        _jax_demo_main()()
    with pytest.raises(SystemExit) as port_exit:
        demo.main([*argv, "--device", "cpu"])
    assert str(port_exit.value) == str(jax_exit.value) == \
        "demo requires an RPN preset (no proposal file input)"


def test_main_runs_on_the_cpu(image_path, tmp_path, monkeypatch, capsys):
    """The CLI with --device cpu and no --weights: JAX's tool's warning and
    lines, and the file that run_demo writes with init_params(seed 0)."""
    _, pcfg = CONFIGS[MASK]
    monkeypatch.setitem(torch_config.PRESETS, MASK, pcfg)
    monkeypatch.setattr(torch_config, "TestConfig", lambda: PTCFG)
    out = str(tmp_path / "cli.png")
    res = demo.main(["--image", image_path, "--out", out, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    n = int((res["scores"] >= 0.7).sum())
    assert lines == ["WARNING: random weights (smoke mode)", "running inference...",
                     f"{len(res['scores'])} detections ({n} above 0.7)", f"wrote {out}"]
    ref = str(tmp_path / "ref.png")
    demo.run_demo(pcfg, PTCFG, params_from_jax(tdet.init_params(pcfg, seed=0)), image_path,
                  ref, device="cpu")
    assert np.array_equal(cv2.imread(out), cv2.imread(ref))


def test_checked_inference_agrees_with_jax():
    """JAX's checked on JAX's inference function and the port's on the
    port's: both pass on an image, both raise on one NaN pixel."""
    jcfg, pcfg = CONFIGS[MASK]
    params = _weights(MASK)
    rng = np.random.RandomState(5)
    image = (rng.randn(64, 96, 3) * 12).astype(np.float32)
    meta = (1.0, 64.0, 96.0)
    jfn = jdebug.checked(jax.jit(jdet.make_inference_fn(jcfg, TCFG)))
    pfn = tdebug.checked(tdet.make_inference_fn(pcfg, PTCFG))
    pparams = params_from_jax(params)

    def port(im):
        return pfn(pparams, torch.from_numpy(im[None]), *[torch.tensor([v]) for v in meta])

    def jax_side(im):
        return jfn(params, jnp.asarray(im), *[jnp.float32(v) for v in meta])

    got, exp = port(image), jax_side(image)
    np.testing.assert_allclose(got.cls_scores[0].numpy(), np.asarray(exp.cls_scores),
                               rtol=0, atol=1e-5)
    tdebug.assert_finite_tree(got, "out")
    bad = image.copy()
    bad[30, 40, 1] = np.nan
    with pytest.raises(ValueError, match="nan generated by primitive"):
        jax_side(bad)
    with pytest.raises(ValueError, match="nan generated by "):
        port(bad)
