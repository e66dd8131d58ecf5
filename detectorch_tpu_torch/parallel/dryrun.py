"""The multi-rank dry run: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

It starts n ranks (``parallel.launch.run_ranks``) on a ('data', 'model')
mesh, data n/2 x model 2 when n is even (fc6/fc7 split over 'model'), and
on each:

  1. one e2e Mask R-CNN training step (``e2e_mask_rcnn_R-50-FPN_2x``, fp32,
     full width) at JAX's reduced counts: 64 rois per image, RPN 256 -> 64,
     a 128x160 blob, one image per data rank, 2 gts with ellipse masks;
     finite losses;
  2. batched inference (RPN 512 -> 256, 50 detections, fp32) at 416x672,
     two images per data rank, through ``make_batched_inference_fn`` on
     ``shard_params`` and ``shard_batch``; the first image of each data
     group is held against one process running the same rows with the
     whole params, over every field of ``ModelOutputs`` (``compare_outputs``).

On CUDA every rank runs both RoIAlign kernels, and TF32 is off. NCCL needs
a card per rank; with fewer cards the ranks share them over gloo.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

E2E_PRESET = "e2e_mask_rcnn_R-50-FPN_2x"
# fp32 tolerances of the sharded-vs-single comparison (JAX's dry run's)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
BOX_TOL = dict(rtol=1e-4, atol=5e-3)
MASK_TOL = dict(rtol=1e-3, atol=1e-4)


def mesh_shape(n_ranks: int) -> Tuple[int, int]:
    """(data, model): model 2 when n is even and > 1, as JAX's dry run."""
    model = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    return n_ranks // model, model


def _train_batch(rng, b, hw, num_classes):
    """JAX's dry-run batch: b noise images, 2 gts each with ellipse rasters."""
    from detectorch_tpu_torch.train.e2e import GT_RASTER_RES

    gt_pad, mg = 4, GT_RASTER_RES
    gt = np.zeros((b, gt_pad, 4), np.float32)
    gm = np.zeros((b, gt_pad, mg, mg), np.uint8)
    valid = np.zeros((b, gt_pad), bool)
    gcls = np.zeros((b, gt_pad), np.int32)
    yy, xx = np.mgrid[0:mg, 0:mg].astype(np.float32) / mg - 0.5
    for i in range(b):
        for g in range(2):
            x1, y1 = rng.uniform(4, 60), rng.uniform(4, 50)
            gt[i, g] = [x1, y1, x1 + rng.uniform(24, 80), y1 + rng.uniform(20, 60)]
            gm[i, g] = (xx / 0.4) ** 2 + (yy / 0.35) ** 2 <= 1.0
            valid[i, g] = True
            gcls[i, g] = 1 + rng.randint(0, num_classes - 1)
    return {"image": rng.randn(b, *hw, 3).astype(np.float32), "gt_boxes": gt,
            "gt_classes": gcls, "gt_valid": valid, "gt_masks": gm, "gt_mask_valid": valid,
            "info": np.tile(np.asarray([hw[0], hw[1], 1.0], np.float32), (b, 1))}


def _match(a, b):
    """Pair the valid detections of two rows (dicts of host arrays) one to
    one: the same class, scores within SCORE_TOL, boxes within BOX_TOL.
    Returns (pairs, unpaired rows of a, unpaired rows of b)."""
    pairs, free = [], set(np.flatnonzero(b["valid"]))
    for i in np.flatnonzero(a["valid"]):
        for j in sorted(free):
            if (a["classes"][i] == b["classes"][j]
                    and np.allclose(a["scores"][i], b["scores"][j], **SCORE_TOL)
                    and np.allclose(a["boxes"][i], b["boxes"][j], **BOX_TOL)):
                pairs.append((i, j))
                free.discard(j)
                break
    paired = {i for i, _ in pairs}
    return pairs, [i for i in np.flatnonzero(a["valid"]) if i not in paired], sorted(free)


def to_host(tree):
    """Tensors of nested NamedTuples (``ModelOutputs``), tuples and dicts ->
    dicts of numpy arrays (floats as fp32), for comparing and pickling."""
    import torch

    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: to_host(getattr(tree, k)) for k in tree._fields}
    return tree


def compare_outputs(out, ref, row: int, ref_row: int = 0) -> Dict[str, float]:
    """Image `row` of outputs `out` against image `ref_row` of `ref` (both
    ``to_host`` trees of ``ModelOutputs``). Per roi: roi_valid exactly,
    rois, class scores and deltas within the tolerances above. The
    detections are paired by class, score and box (slots of near-tied
    scores may come in either order); a detection without a partner is
    allowed only at the cut, its score within SCORE_TOL of the weakest kept
    one, where a near tie decides which of two candidates stays. Paired
    masks within MASK_TOL. Returns the largest differences and the counts."""
    np.testing.assert_array_equal(out["roi_valid"][row], ref["roi_valid"][ref_row],
                                  err_msg="roi_valid")
    errs = {}
    for name, tol in (("rois", BOX_TOL), ("cls_scores", SCORE_TOL),
                      ("bbox_deltas", SCORE_TOL)):
        a, b = out[name][row], ref[name][ref_row]
        np.testing.assert_allclose(a, b, err_msg=name, **tol)
        errs[name] = float(np.abs(a - b).max())
    dets = [{k: v[r] for k, v in o["detections"].items()}
            for o, r in ((out, row), (ref, ref_row))]
    pairs, lone_a, lone_b = _match(*dets)
    for d, lone in zip(dets, (lone_a, lone_b)):
        cut = d["scores"][d["valid"]].min() if d["valid"].any() else 0.0
        for i in lone:
            if not np.allclose(d["scores"][i], cut, **SCORE_TOL):
                raise AssertionError(f"detection {i} (class {d['classes'][i]}, score "
                                     f"{d['scores'][i]}) has no partner and is not at the cut")
    ia, ib = [i for i, _ in pairs], [j for _, j in pairs]
    errs["scores"] = float(np.abs(dets[0]["scores"][ia] - dets[1]["scores"][ib]).max()) \
        if pairs else 0.0
    if out.get("masks") is not None:
        ma, mb = out["masks"][row][ia], ref["masks"][ref_row][ib]
        np.testing.assert_allclose(ma, mb, err_msg="masks", **MASK_TOL)
        errs["masks"] = float(np.abs(ma - mb).max()) if ma.size else 0.0
    errs.update(detections=len(pairs), unpaired_at_cut=len(lone_a) + len(lone_b))
    return errs


def _rank(device_type: str, model: int, train_hw, infer_hw) -> Dict:
    """One rank of the dry run; returns its losses, comparison and the
    kernels' launch counts."""
    import torch

    from detectorch_tpu_torch.checkpoint.convert import params_from_jax
    from detectorch_tpu_torch.config import (
        PRESETS,
        RPNConfig,
        SamplerConfig,
        SolverConfig,
        TestConfig,
    )
    from detectorch_tpu_torch.models.detector import init_params, make_inference_fn
    from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd, roi_align_fwd
    from detectorch_tpu_torch.parallel.mesh import (
        default_device,
        make_batched_inference_fn,
        make_mesh,
        shard_batch,
        shard_params,
    )
    from detectorch_tpu_torch.train.e2e import make_e2e_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = default_device() if device_type == "cuda" else torch.device("cpu")
    mesh = make_mesh(model_parallel=model, device=device)
    data = mesh.shape["data"]
    rng = np.random.RandomState(0)

    # 1. the e2e Mask R-CNN step, one image per data rank
    cfg = PRESETS[E2E_PRESET].replace(compute_dtype="float32")
    init_state, make_step = make_e2e_train_step(
        cfg, SolverConfig(base_lr=1e-4), SamplerConfig(rois_per_image=64), seed=0,
        train_pre_nms=256, train_post_nms=64, train_mask=True, mesh=mesh)
    state, opt = init_state(params_from_jax(init_params(cfg, seed=0)))
    batch = _train_batch(rng, data, train_hw, cfg.num_classes)
    keys = list(batch)
    state, metrics = make_step(opt)(state, dict(zip(keys, shard_batch(mesh, *batch.values()))))
    losses = {k: float(v) for k, v in metrics.items() if k.startswith("loss")}
    if not all(np.isfinite(v) for v in losses.values()):
        raise FloatingPointError(f"non-finite losses {losses}")
    del state, opt
    train_launches = (roi_align_fwd.launches, roi_align_bwd.launches)

    # 2. sharded inference, two images per data rank
    icfg = cfg.replace(rpn=RPNConfig(pre_nms_top_n=512, post_nms_top_n=256))
    itc = TestConfig(detections_per_img=50)
    iparams = params_from_jax(init_params(icfg, seed=1))
    b, (h, w) = 2 * data, infer_hw
    images = (rng.randn(b, h, w, 3) * 40).astype(np.float32)
    scalars = [np.full(b, v, np.float32) for v in (0.83, 500.0, 800.0)]
    full = {k: v.to(device) for k, v in iparams.items()}
    out = make_batched_inference_fn(icfg, itc, mesh)(
        shard_params(iparams, mesh), *shard_batch(mesh, images, *scalars))
    infer_launches = roi_align_fwd.launches - train_launches[0]
    if not bool(torch.isfinite(out.detections.scores).all()):
        raise FloatingPointError("non-finite detection scores")
    # one process, the whole params, this rank's rows: the group's first
    # image against the gathered outputs
    rows = shard_batch(mesh, images, *scalars)
    ref = make_inference_fn(icfg, itc)(full, *rows)
    errs = compare_outputs(to_host(out), to_host(ref), mesh.coords["data"] * (b // data))
    return {"mesh": dict(mesh.shape), "rank": mesh.rank, "device": str(device),
            "losses": losses, "compare": errs,
            "launches": {"train": train_launches,
                         "inference": (infer_launches, 0)}}


def dryrun_multichip(n_ranks: int, device: str = "cuda", train_hw=(128, 160),
                     infer_hw=(416, 672)) -> list:
    """Run the dry run on `n_ranks` ranks (each rank's result, in rank
    order). `device` 'cuda' puts rank r on card r mod the card count, over
    NCCL where there is a card per rank and gloo otherwise; 'cpu' runs
    gloo."""
    import torch

    from detectorch_tpu_torch.parallel.launch import run_ranks

    _, model = mesh_shape(n_ranks)
    if device == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' for the gloo run")
        backend = "nccl" if cards >= n_ranks else "gloo"
        local = [r % cards for r in range(n_ranks)]
    else:
        backend, local = "gloo", [0] * n_ranks
    return run_ranks(_rank, n_ranks, (device, model, tuple(train_hw), tuple(infer_hw)),
                     backend, local)
