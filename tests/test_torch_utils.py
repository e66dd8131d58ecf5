"""The port's host utilities held to the JAX package's on the same inputs:
colormap, io, selective_search, vis (pixel for pixel), debug and profiling.

colormap, io, selective_search and vis are copies of numpy / cv2 /
matplotlib code, so their results must be equal: arrays bit for bit, images
pixel for pixel (PNG files decoded; PDFs carry their creation date, so they
are not compared). cv2 here has no ``ximgproc``, so both packages'
``selective_search`` take the sliding-window path; the ximgproc branch is
copied verbatim and not run here. debug and profiling are ports (torch in
place of checkify and jax.profiler): they run JAX's own cases
(tests/test_debug.py, tests/test_profiling.py) on the same inputs, with the
same outcomes and messages.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.eval import rle as jrle
from detectorch_tpu.utils import colormap as jcolormap
from detectorch_tpu.utils import debug as jdebug
from detectorch_tpu.utils import io as jio
from detectorch_tpu.utils import profiling as jprofiling
from detectorch_tpu.utils import selective_search as jss
from detectorch_tpu.utils import vis as jvis
from detectorch_tpu_torch.eval import rle as trle
from detectorch_tpu_torch.utils import colormap as tcolormap
from detectorch_tpu_torch.utils import debug as tdebug
from detectorch_tpu_torch.utils import io as tio
from detectorch_tpu_torch.utils import profiling as tprofiling
from detectorch_tpu_torch.utils import selective_search as tss
from detectorch_tpu_torch.utils import vis as tvis


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The Tier-1 command runs six pytest workers on the CPU: one intra-op
    torch thread per worker in this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def dets():
    """tests/test_vis.py's detections: two boxes with masks."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (120, 160, 3), np.uint8)
    boxes = np.array([[10, 10, 70, 60], [80, 30, 150, 110]], np.float32)
    scores = np.array([0.95, 0.8], np.float32)
    classes = np.array([1, 17], np.int64)
    masks = []
    for x1, y1, x2, y2 in boxes.astype(int):
        m = np.zeros((120, 160), np.uint8)
        m[y1 + 5:y2 - 5, x1 + 5:x2 - 5] = 1
        masks.append(jrle.encode(np.asfortranarray(m)))
    return img, boxes, scores, classes, masks


def _keypoints(boxes, seed, logit):
    """(N, 17, 4) [x, y, logit, prob] spread inside each box."""
    rng = np.random.RandomState(seed)
    kps = np.zeros((len(boxes), 17, 4), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        kps[i, :, 0] = rng.uniform(x1, x2, 17)
        kps[i, :, 1] = rng.uniform(y1, y2, 17)
        kps[i, :, 2] = logit
        kps[i, :, 3] = 0.9
    return kps


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("maximum", [255, 1])
def test_colormap_matches(rgb, maximum):
    got, exp = tcolormap.colormap(rgb, maximum), jcolormap.colormap(rgb, maximum)
    assert got.dtype == exp.dtype and np.array_equal(got, exp)


def test_io_round_trips_match(tmp_path):
    obj = {"boxes": np.arange(12, dtype=np.float32).reshape(3, 4), "names": ["a", "b"],
           "nested": {"k": (1, 2.5, None)}}
    tio.save_object(obj, str(tmp_path / "port" / "obj.pkl"))
    jio.save_object(obj, str(tmp_path / "jax" / "obj.pkl"))
    written = [(tmp_path / side / "obj.pkl").read_bytes() for side in ("port", "jax")]
    assert written[0] == written[1]
    for load in (tio.load_object, jio.load_object):
        back = load(str(tmp_path / "port" / "obj.pkl"))
        assert back.keys() == obj.keys() and back["names"] == obj["names"]
        assert back["nested"] == obj["nested"] and np.array_equal(back["boxes"], obj["boxes"])
    assert not hasattr(tio, "enable_persistent_compile_cache")


@pytest.mark.parametrize("hw", [(120, 160), (480, 640), (50, 30)])
def test_selective_search_matches(hw):
    im = np.zeros((*hw, 3), np.uint8)
    assert tss.has_ximgproc() == jss.has_ximgproc()
    for fn in ("_sliding_window_proposals", "selective_search"):
        for max_boxes in (2000, 17):
            got = getattr(tss, fn)(im, max_boxes=max_boxes)
            exp = getattr(jss, fn)(im, max_boxes=max_boxes)
            assert got.dtype == exp.dtype == np.float32 and np.array_equal(got, exp)


@pytest.mark.parametrize("what", ["masks", "keypoints", "both", "none"])
def test_opencv_renderer_matches(dets, what):
    img, boxes, scores, classes, rles = dets
    kps = _keypoints(boxes, 5, 5.0) if what in ("keypoints", "both") else None
    masks = rles if what in ("masks", "both") else None
    got = tvis.vis_one_image_opencv(img, boxes, scores, classes, masks, kps, thresh=0.5)
    exp = jvis.vis_one_image_opencv(img, boxes, scores, classes, masks, kps, thresh=0.5)
    assert got.dtype == exp.dtype == np.uint8 and np.array_equal(got, exp)
    assert (got != img).any()
    cold = _keypoints(boxes, 5, -5.0)[0]
    assert np.array_equal(tvis.vis_keypoints(img, cold), jvis.vis_keypoints(img, cold))


def test_vis_one_image_writes_the_same_file(dets, tmp_path):
    img, boxes, scores, classes, rles = dets
    kps = _keypoints(boxes, 7, 10.0)
    outs = []
    for mod in (tvis, jvis):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.png")
        drawn = mod.vis_one_image(img, boxes, scores, classes, rles, kps, thresh=0.5,
                                  output_path=path)
        outs.append((drawn, cv2.imread(path)[:, :, ::-1]))
    (t_drawn, t_file), (j_drawn, j_file) = outs
    assert np.array_equal(t_drawn, j_drawn) and np.array_equal(t_file, j_file)
    assert np.array_equal(t_file, t_drawn)


@pytest.mark.parametrize("keypoints", [False, True])
def test_matplotlib_renderer_matches(dets, tmp_path, keypoints):
    img, boxes, scores, classes, rles = dets
    kps = _keypoints(boxes, 7, 10.0) if keypoints else None
    saved = []
    for mod in (tvis, jvis):
        out_dir = str(tmp_path / mod.__name__.split(".")[0])
        path = mod.vis_one_image_matplotlib(img, boxes, scores, classes, rles, kps, thresh=0.5,
                                            output_dir=out_dir, im_name="sample", ext="png")
        assert path == os.path.join(out_dir, "sample.png")
        saved.append(cv2.imread(path, cv2.IMREAD_UNCHANGED))
    assert saved[0].shape == saved[1].shape and np.array_equal(saved[0], saved[1])


def test_matplotlib_below_thresh_matches(dets, tmp_path):
    img, boxes, scores, classes, rles = dets
    for mod in (tvis, jvis):
        out_dir = tmp_path / mod.__name__.split(".")[0]
        assert mod.vis_one_image_matplotlib(img, boxes, scores, classes, rles, thresh=0.99,
                                            output_dir=str(out_dir), im_name="sample") is None
        assert not out_dir.exists()


@pytest.mark.parametrize("with_extras", [False, True])
def test_to_cls_format_matches(dets, with_extras):
    _, boxes, scores, classes, rles = dets
    boxes = np.concatenate([boxes, boxes + 3])
    scores = np.concatenate([scores, scores / 2])
    classes = np.array([1, 17, 17, 80])
    rles = rles + rles if with_extras else None
    kps = _keypoints(boxes, 2, 3.0) if with_extras else None
    got = tvis.to_cls_format(boxes, scores, classes, rles, kps)
    exp = jvis.to_cls_format(boxes, scores, classes, rles, kps)
    for g, e in zip(got[0], exp[0]):
        assert g.dtype == e.dtype and np.array_equal(g, e)
    assert got[1] == exp[1]
    if with_extras:
        for g, e in zip(got[2], exp[2]):
            assert len(g) == len(e) and all(np.array_equal(a, b) for a, b in zip(g, e))
    else:
        assert got[2] is exp[2] is None


def test_vis_decodes_the_ports_rles(dets):
    """The port's RLEs (from its native library) render as JAX's do."""
    img, boxes, scores, classes, rles = dets
    port_rles = [trle.encode(jrle.decode(r)) for r in rles]
    assert port_rles == rles
    got = tvis.vis_one_image_opencv(img, boxes, scores, classes, port_rles, thresh=0.5)
    exp = jvis.vis_one_image_opencv(img, boxes, scores, classes, rles, thresh=0.5)
    assert np.array_equal(got, exp)


# -- debug: tests/test_debug.py's cases on both sides ------------------------


def test_checked_passes_clean_fn():
    x = np.asarray([1.0, 4.0], np.float32)
    got = tdebug.checked(lambda a: torch.sqrt(a) * 2)(torch.from_numpy(x))
    exp = jdebug.checked(lambda a: jnp.sqrt(a) * 2)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), [2.0, 4.0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_checked_catches_nan():
    x = np.asarray([-1.0], np.float32)
    with pytest.raises(ValueError, match="nan generated by primitive: log"):
        jdebug.checked(lambda a: jnp.log(a))(jnp.asarray(x))
    with pytest.raises(ValueError, match="nan generated by torch.log"):
        tdebug.checked(lambda a: torch.log(a))(torch.from_numpy(x))
    with pytest.raises(ValueError, match="nan generated by Tensor.log"):
        tdebug.checked(lambda a: a.exp().log() * a.log())(torch.from_numpy(x))


def test_checked_lets_inf_and_uninitialised_memory_pass():
    """float_checks flags NaN only: -inf fills (the NMS's) pass on both
    sides; an uninitialised buffer is not read before it is written."""
    got = tdebug.checked(lambda: torch.full((3,), -float("inf")).max() + 1)()
    exp = jdebug.checked(lambda: jnp.full((3,), -jnp.inf).max() + 1)()
    assert float(got) == float(exp) == -np.inf
    buf = tdebug.checked(lambda: torch.empty(4096).fill_(2.0).sum())()
    assert float(buf) == 8192.0


@pytest.mark.parametrize("tree, path", [
    ({"a": np.ones(3), "b": [np.zeros(2)]}, None),
    ({"a": np.array([1.0, np.nan])}, "tree['a']"),
    ({"b": [np.zeros(2), np.array([np.inf])], "a": np.ones(2)}, "tree['b'][1]"),
    ({"z": np.ones(1), "a": (np.zeros(1), {"k": np.array([-np.inf])})}, "tree['a'][1]['k']"),
    ({"ints": np.arange(3), "none": None, "x": 2.0}, None),
])
def test_assert_finite_tree_matches(tree, path):
    port_tree = {k: [torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x
                     for x in v] if isinstance(v, list) else v for k, v in tree.items()}
    for side, t in ((jdebug, tree), (tdebug, tree), (tdebug, port_tree)):
        if path is None:
            side.assert_finite_tree(t)
        else:
            with pytest.raises(AssertionError) as err:
                side.assert_finite_tree(t)
            assert str(err.value) == f"non-finite values in {path}"


def test_assert_finite_tree_names_named_tuple_fields():
    from detectorch_tpu_torch.eval.postprocess import Detections

    d = Detections(*[torch.zeros(1, 2, 4), torch.tensor([[0.5, np.nan]]),
                     torch.zeros(1, 2, dtype=torch.int64), torch.ones(1, 2, dtype=torch.bool),
                     torch.ones(1, dtype=torch.bool)])
    jd = jax.tree.map(lambda t: np.asarray(t), d)
    with pytest.raises(AssertionError, match=r"out\.scores$"):
        tdebug.assert_finite_tree(d, "out")
    with pytest.raises(AssertionError, match=r"out\.scores$"):
        jdebug.assert_finite_tree(jd, "out")


# -- profiling: tests/test_profiling.py's cases on both sides ------------------


def test_device_timer_measures_work():
    x = np.ones((256, 256), np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jfn = jax.jit(lambda: (jx @ jx).sum())
    for timer, fn in ((jprofiling.device_timer, jfn),
                      (tprofiling.device_timer, lambda: (tx @ tx).sum())):
        assert timer(fn, iters=3, pipeline=False) > 0
        assert timer(fn, iters=3, pipeline=True) > 0


def test_device_timer_calls_as_jax_does():
    """A warm-up call, then `iters` calls, pipelined or not."""
    for pipeline in (False, True):
        calls = {"jax": 0, "port": 0}

        def count(side):
            def fn(a):
                calls[side] += 1
                return (a * 2,)
            return fn

        jprofiling.device_timer(count("jax"), jnp.ones(4), iters=4, pipeline=pipeline)
        tprofiling.device_timer(count("port"), torch.ones(4), iters=4, pipeline=pipeline)
        assert calls["jax"] == calls["port"] == 5


def test_trace_writes_logdir(tmp_path):
    for side, run in (("jax", lambda: jax.jit(lambda a: a * 2)(jnp.ones(8)).block_until_ready()),
                      ("port", lambda: torch.ones(8) * 2)):
        logdir = str(tmp_path / side / "trace")
        trace = jprofiling.trace if side == "jax" else tprofiling.trace
        with trace(logdir) as d:
            assert d == logdir
            run()
        found = [f for _, _, files in os.walk(logdir) for f in files]
        assert found, f"no trace files written ({side})"
    port = [f for _, _, files in os.walk(tmp_path / "port") for f in files]
    assert len(port) == 1 and port[0].endswith(".json")
    with open(os.path.join(tmp_path / "port" / "trace", port[0])) as f:
        assert '"traceEvents"' in f.read()
