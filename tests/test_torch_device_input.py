"""The port's batched on-device preprocessing against the JAX package's
``device_preprocess`` and against the host cv2 path.

Against JAX on the same tables: atol 1e-4 on the 0-255 scale (the same
fp32 blends in the same order). Against ``cv2.resize`` of the host blob:
atol 2e-2, as tests/test_device_input.py holds JAX's version (cv2 blends
horizontal-then-vertical, a float32 associativity difference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectorch_tpu.data import device_input as jdi
from detectorch_tpu.data import transforms as T
from detectorch_tpu_torch.data import device_input as tdi


def _run(ims, **kw):
    """Host prep of each image, then one batched device_preprocess."""
    prepped = [tdi.prepare_raw(im, **kw) for im in ims]
    raws = np.stack([r for r, _ in prepped])
    packed = [tdi.pack_tables_meta(m) for _, m in prepped]
    tables = np.stack([t for t, _ in packed])
    meta = np.stack([m for _, m in packed])
    m0 = prepped[0][1]
    out = tdi.device_preprocess(torch.from_numpy(raws), torch.from_numpy(tables),
                                torch.from_numpy(meta), m0["out_h"], m0["out_w"])
    return out.numpy(), prepped


def test_host_tables_equal_jax(rng):
    im = rng.randint(0, 256, (333, 500, 3)).astype(np.uint8)
    raw, m = tdi.prepare_raw(im)
    jraw, jm = jdi.prepare_raw(im)
    assert np.array_equal(raw, jraw) and tdi.RAW_STRIDE == jdi.RAW_STRIDE
    for a, b in zip(tdi.pack_tables_meta(m), jdi.pack_tables_meta(jm)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (333, 500), (100, 1000)])
def test_matches_jax_and_cv2(rng, hw):
    im = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    (dev,), ((raw, m),) = _run([im])
    t = m["tables"]
    exp = np.asarray(jdi.device_preprocess(
        jnp.asarray(raw), t["y_i0"], t["y_w1"], t["x_i0"], t["x_w1"],
        m["raw_h"], m["raw_w"], m["rsz_h"], m["rsz_w"]))
    assert dev.shape == exp.shape == (m["out_h"], m["out_w"], 3)
    np.testing.assert_allclose(dev, exp, rtol=0, atol=1e-4)
    host, scale, _ = T.preprocess_image(im, 800, 1333, pad_stride=32, buckets=T.DEFAULT_BUCKETS)
    assert m["scale"] == scale and host.shape == dev.shape
    np.testing.assert_allclose(dev, host, rtol=0, atol=2e-2)
    # the padding is exactly 0.0, not -mean
    rh, rw = m["rsz_h"], m["rsz_w"]
    assert (dev[rh:] == 0).all() and (dev[:, rw:] == 0).all()
    assert (dev[:rh, :rw] != 0).any()


def test_batch_equals_each_image_alone(rng):
    # three sizes in one raw bucket (480 x 640) and one output bucket
    ims = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
           for h, w in ((480, 640), (470, 630), (400, 600))]
    batch, prepped = _run(ims)
    assert len({r.shape for r, _ in prepped}) == 1
    for i, im in enumerate(ims):
        (alone,), _ = _run([im])
        assert np.array_equal(batch[i], alone)
    assert not np.array_equal(batch[0], batch[1])


def test_grayscale(rng):
    gray = rng.randint(0, 256, (60, 90)).astype(np.uint8)
    (dev,), ((raw, m),) = _run([gray], target_size=64, max_size=96, buckets=None)
    assert raw.shape[-1] == 3
    (rgb,), _ = _run([np.repeat(gray[:, :, None], 3, axis=2)], target_size=64, max_size=96,
                     buckets=None)
    assert np.array_equal(dev, rgb)
    with pytest.raises(ValueError):
        tdi.prepare_raw(gray.astype(np.float32))
