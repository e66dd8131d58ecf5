"""The e2e training case that tests/test_torch_e2e_*.py hold the port to JAX on.

Two images at full R-50-FPN (or R-50-C4) widths in a 64x128 blob (the JAX
package's e2e tests' size), 2-3 gt boxes each with polygon masks, gt_pad 8,
SamplerConfig(rois_per_image=32), train counts pre 200 / post 64; weights
from tests/test_torch_train._params. JAX runs ``make_e2e_train_step`` with
roi_align_impl='pallas-slab' (Pallas kernels in interpret mode) for FPN,
as tests/test_torch_train.py runs ``make_train_step``, and 'gather' (its
only choice: the separable ``roi_align_matmul``) for C4; the port runs its
own with the uniforms that JAX's keys give (``jax_uniforms``).

How the sampled sets are compared, and why: the anchor targets come from
inputs that are equal on both sides and are equal bit for bit; the
proposals come out of the convolutions, which the two frameworks round
differently, so their boxes agree only within ROI_ATOL. ``jax_sampled``
recomputes JAX's step-0 sample from JAX's own functions, and the tests ask
for the same labels, validity and gt indices row for row, and rois within
ROI_ATOL: with equal sets, the losses and gradients can be held to float
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from detectorch_tpu.data.device_input import pack_tables_meta, prepare_raw
from detectorch_tpu.models import fpn as jfpn
from detectorch_tpu.models import resnet as jresnet
from detectorch_tpu.models import rpn as jrpn
from detectorch_tpu.train import e2e as JE
from detectorch_tpu.train.sampler import polys_to_mask_wrt_box
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.train import e2e as E
from tests.test_torch_train import _jax_trace
from tests.torch_configs import both_configs

B, G, H, W = 2, 8, 64, 128
PRE, POST, SEED = 200, 64, 5
SAMPLER, PSAMPLER = both_configs(lambda c: c.SamplerConfig(rois_per_image=32))
SOLVER, PSOLVER = both_configs(lambda c: c.SolverConfig(base_lr=0.01, warmup_iters=0))
# the C4 case's step-0 gradient norm passes the schedule's clip (35): its
# tests run without the clip, so that JAX's optax trace holds the gradient
SOLVER_NO_CLIP, PSOLVER_NO_CLIP = both_configs(
    lambda c: c.SolverConfig(base_lr=0.01, warmup_iters=0, clip_grad_norm=1e9))
ROI_ATOL = 2e-3  # px: backbone drift of ~1e-6 through exp() of the RPN deltas
# (original h, w) of the two images: resized into the 64x128 blob at scales
# 1.0667 (64x128) and 1.1636 (58x128)
ORIG = ((60, 120), (50, 110))


def cfgs(preset, **kw):
    return both_configs(lambda c: c.PRESETS[preset].replace(**kw))


def roi_align_impl(cfg):
    """JAX's Pallas names are the FPN path; C4 trains with 'gather'."""
    return "pallas-slab" if cfg.use_fpn else "gather"


def _ellipse(box):
    x1, y1, x2, y2 = box
    ang = np.linspace(0, 2 * np.pi, 13)[:-1]
    return np.stack([(x1 + x2) / 2 + (x2 - x1) / 2 * np.cos(ang),
                     (y1 + y2) / 2 + (y2 - y1) / 2 * np.sin(ang)], 1).reshape(-1)


def make_batch(seed, train_mask, device_input, keypoints=0):
    """Numpy batch of the case, in the host-blob or the uint8 schema. With
    `keypoints` > 0, each gt carries that many keypoints inside its box
    (input-scaled, a fifth unlabelled) as gt_keypoints (B, G, keypoints, 3),
    drawn after everything else so that the rest of the batch is that of
    the seed without keypoints."""
    rng = np.random.RandomState(seed)
    batch = {"gt_boxes": np.zeros((B, G, 4), np.float32), "gt_classes": np.zeros((B, G), np.int32),
             "gt_valid": np.zeros((B, G), bool)}
    raws, tables, metas, info = [], [], [], []
    for i, (oh, ow) in enumerate(ORIG):
        im = rng.randint(0, 256, (oh, ow, 3)).astype(np.uint8)
        raw, m = prepare_raw(im, target_size=H, max_size=W, buckets=((H, W),), raw_stride=16)
        padded = np.zeros((H, W, 3), np.uint8)
        padded[: raw.shape[0], : raw.shape[1]] = raw
        t, meta = pack_tables_meta(m)
        raws.append(padded)
        tables.append(t)
        metas.append(meta)
        scale = m["scale"]
        info.append([m["rsz_h"], m["rsz_w"], scale])
        n = 2 + i
        side = rng.uniform(10, 0.8 * min(oh, ow), (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * ([ow, oh] - side)
        boxes = np.concatenate([xy, xy + side], 1)
        batch["gt_boxes"][i, :n] = boxes * scale
        batch["gt_classes"][i, :n] = rng.randint(1, 81, n)
        batch["gt_valid"][i, :n] = True
        if train_mask:
            batch.setdefault("gt_masks", np.zeros((B, G, JE.GT_RASTER_RES, JE.GT_RASTER_RES),
                                                  np.uint8))
            batch.setdefault("gt_mask_valid", np.zeros((B, G), bool))
            for j in range(n):
                batch["gt_masks"][i, j] = polys_to_mask_wrt_box([_ellipse(boxes[j])], boxes[j],
                                                                JE.GT_RASTER_RES)
            batch["gt_mask_valid"][i, :n] = True
            batch["gt_mask_valid"][i, 0] = i == 0  # one gt without a polygon
    if device_input:
        batch.update(raw=np.stack(raws), tables=np.stack(tables), meta=np.stack(metas))
    else:
        # the host-blob schema: an image of noise over the whole padded blob
        batch["image"] = (rng.randn(B, H, W, 3) * 30).astype(np.float32)
        batch["info"] = np.asarray(info, np.float32)
    if keypoints:
        gb = batch["gt_boxes"]
        kxy = gb[:, :, None, :2] + rng.uniform(0, 1, (B, G, keypoints, 2)) \
            * (gb[:, :, None, 2:] - gb[:, :, None, :2])
        vis = np.where(rng.rand(B, G, keypoints) < 0.2, 0.0, 2.0) * batch["gt_valid"][..., None]
        batch["gt_keypoints"] = np.concatenate([kxy, vis[..., None]], -1).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_uniforms(seed=SEED):
    """The port's ``uniforms`` argument: for step s, the vectors that JAX's
    step draws from fold_in(PRNGKey(seed), s), split per image, then split
    as ``e2e_losses``, ``rpn_targets`` and ``sample_rois_device`` split."""
    def draw(step, batch_size, n_anchors, n_cand, device):
        out = {k: [] for k in E.UNIFORM_KEYS}
        base = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        for key in jax.random.split(base, batch_size):
            k_anchor, k_roi = jax.random.split(key)
            a1, a2 = jax.random.split(k_anchor)
            r1, r2, r3 = jax.random.split(k_roi, 3)
            for name, k, n, top in (("anchor_pos", a1, n_anchors, 1.0),
                                    ("anchor_neg", a2, n_anchors, 1.0),
                                    ("roi_fg", r1, n_cand, 1.0), ("roi_bg", r2, n_cand, 1.0),
                                    ("roi_order", r3, n_cand, 0.5)):
                out[name].append(np.asarray(jax.random.uniform(k, (n,), maxval=top)))
        return {k: torch.from_numpy(np.stack(v)).to(device) for k, v in out.items()}

    return draw


def run_jax(cfg, params, batch, train_mask, device_input, steps, solver=SOLVER,
            train_keypoints=False):
    """JAX's metrics per step, its step-0 gradient and its params after
    `steps` steps, both in the port's layout."""
    init_state, make_step = JE.make_e2e_train_step(
        cfg, solver, SAMPLER, seed=SEED, train_pre_nms=PRE, train_post_nms=POST,
        train_mask=train_mask, train_keypoints=train_keypoints, device_input=device_input,
        blob_hw=(H, W), roi_align_impl=roi_align_impl(cfg))
    state, tx = init_state(params)
    step = jax.jit(make_step(tx))
    metrics, grads = [], None
    for i in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            trace = _jax_trace(state.opt_state)
            wd = np.float32(solver.weight_decay)
            grads = {k: np.array(trace[k]) - wd * params[k] for k in params}
            norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
            assert norm < solver.clip_grad_norm  # the trace holds the unclipped gradient
    return (metrics, params_from_jax(grads),
            params_from_jax({k: np.array(v) for k, v in state.params.items()}))


def jax_sampled(cfg, params, images, batch):
    """JAX's step-0 roi sample of each image, from JAX's own backbone, RPN
    head, per-level ``generate_proposals``, ``collect_proposals`` (FPN; C4:
    one level, no collect) and ``sample_rois_device`` with the step's keys."""
    @jax.jit
    def one(image, gt_boxes, gt_classes, gt_valid, info, key):
        _, k_roi = jax.random.split(key)
        if not cfg.use_fpn:
            logits, deltas = jrpn.rpn_head(params, jresnet.c4_body(params, image[None], cfg.arch),
                                           prefix="", return_logits=True)
            p = jrpn.generate_proposals(
                jax.nn.sigmoid(logits[0]), deltas[0], info[0], info[1], info[2],
                feat_stride=1.0 / cfg.spatial_scale, anchor_sizes=cfg.anchors.sizes,
                anchor_aspect_ratios=cfg.anchors.aspect_ratios,
                pre_nms_top_n=min(PRE, logits[0].size), post_nms_top_n=POST,
                nms_thresh=cfg.rpn.nms_thresh, min_size=cfg.rpn.min_size)
            return JE.sample_rois_device(p.boxes, p.valid, gt_boxes, gt_classes, gt_valid,
                                         k_roi, SAMPLER)
        pyramid = jfpn.fpn_neck(params, jresnet.multilevel_body(params, image[None], cfg.arch),
                                cfg.arch)
        props = []
        for i, feat in enumerate(list(pyramid) + [jfpn.subsample2x(pyramid[-1])]):
            lvl = cfg.fpn.roi_min_level + i
            logits, deltas = jrpn.rpn_head(params, feat, prefix="_fpn2", return_logits=True)
            fh, fw = logits.shape[1:3]
            props.append(jrpn.generate_proposals(
                jax.nn.sigmoid(logits[0]), deltas[0], info[0], info[1], info[2],
                feat_stride=float(2 ** lvl), anchor_sizes=(32.0 * 2 ** (lvl - 2),),
                pre_nms_top_n=min(PRE, fh * fw * 3), post_nms_top_n=POST,
                nms_thresh=cfg.rpn.nms_thresh, min_size=cfg.rpn.min_size))
        p = jrpn.collect_proposals(props, POST)
        return JE.sample_rois_device(p.boxes, p.valid, gt_boxes, gt_classes, gt_valid, k_roi,
                                     SAMPLER)

    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), 0), B)
    return [jax.tree.map(np.asarray, one(jnp.asarray(images[i]), batch["gt_boxes"][i],
                                         batch["gt_classes"][i], batch["gt_valid"][i],
                                         jnp.asarray(info), keys[i]))
            for i, info in enumerate(_info(batch))]


def _info(batch):
    return batch["meta"][:, 2:5] if "meta" in batch else batch["info"]


def port_losses(pcfg, params, batch, train_mask, device_input, roi_align=None,
                train_keypoints=False):
    """The port's per-image losses, metrics, sample and step-0 gradient,
    through ``e2e_losses`` with JAX's step-0 uniforms. Also returns the
    images the step saw (after ``device_images`` in the uint8 schema)."""
    from detectorch_tpu_torch.train.train_step import device_images, make_init_state

    state, _ = make_init_state(PSOLVER)(params_from_jax(params))
    tb = torch_batch(batch)
    images = device_images(tb, (H, W)) if device_input else tb["image"]
    extras = ({"gt_masks": tb["gt_masks"], "gt_mask_valid": tb["gt_mask_valid"]}
              if train_mask else {})
    if train_keypoints:
        extras["gt_keypoints"] = tb["gt_keypoints"]
    draw = jax_uniforms()
    kw = {} if roi_align is None else {"roi_align": roi_align}
    total, metrics, sampled = E.e2e_losses(
        state.params, pcfg, PSAMPLER, images, tb["gt_boxes"], tb["gt_classes"],
        tb["gt_valid"], torch.from_numpy(_info(batch)),
        lambda na, nc: draw(0, B, na, nc, images.device), train_pre_nms=PRE,
        train_post_nms=POST, extras=extras, **kw)
    total.mean().backward()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in state.params.items() if v.requires_grad}
    return total.detach(), metrics, sampled, grads, images.detach().numpy()


def run_port(pcfg, params, batch, train_mask, device_input, steps, solver=PSOLVER,
             train_keypoints=False):
    init_state, make_step = E.make_e2e_train_step(
        pcfg, solver, PSAMPLER, seed=SEED, train_pre_nms=PRE, train_post_nms=POST,
        train_mask=train_mask, train_keypoints=train_keypoints, device_input=device_input,
        blob_hw=(H, W), roi_align_impl=roi_align_impl(pcfg), uniforms=jax_uniforms())
    state, opt = init_state(params_from_jax(params))
    step = make_step(opt)
    metrics = []
    for _ in range(steps):
        state, m = step(state, torch_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.detach() for k, v in state.params.items()}
