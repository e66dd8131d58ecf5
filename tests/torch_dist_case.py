"""The multi-rank cases of tests/test_torch_parallel*.py, run inside the
ranks that ``detectorch_tpu_torch.parallel.launch.run_ranks`` starts.

This module imports no JAX and nothing of the JAX package: each rank is a
fresh interpreter (``spawn``), and tests/conftest.py, which imports JAX,
does not run there. The test process builds every input with numpy (and
JAX where it is the reference) and passes it in; each case returns numpy
arrays and floats for the test process to hold against world 1.

Each rank runs the cases in order on the gloo backend on the CPU, with one
torch thread (``run_ranks`` sets it).
"""

import functools

import numpy as np
import torch

from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.config import PRESETS, KeypointConfig, RPNConfig, SolverConfig
from detectorch_tpu_torch.models.detector import init_params
from detectorch_tpu_torch.parallel.dryrun import to_host

MASK = "e2e_mask_rcnn_R-50-FPN_2x"
KP = "e2e_keypoint_rcnn_R-50-FPN_1x"
SOLVER = SolverConfig(base_lr=0.01, warmup_iters=0)


def cfg_of(name: str):
    """The cases' configs, fp32: 'mask' (e2e Mask R-CNN R-50-FPN at full
    width), 'mask_small_rpn' (the same, RPN 100 -> 20 per level, for
    inference), 'kp' (Keypoint R-CNN with the keypoint tests' small head,
    2 convs of 32)."""
    if name == "kp":
        return PRESETS[KP].replace(compute_dtype="float32",
                                   keypoint=KeypointConfig(num_convs=2, conv_dim=32))
    cfg = PRESETS[MASK].replace(compute_dtype="float32")
    return cfg.replace(rpn=RPNConfig(pre_nms_top_n=100, post_nms_top_n=20)) \
        if name == "mask_small_rpn" else cfg


@functools.lru_cache(maxsize=None)
def case_params(cfg, mask_bias: bool = False):
    """JAX-layout numpy params: ``init_params(seed 0)`` with the BN scales
    and biases redrawn, as tests/test_torch_train._params does (the init's
    zero branch2c scales would cut every residual branch out of the
    gradient). mask_bias puts a +-3 bias on alternate mask classes, so that
    eval's masks sit away from the 0.5 threshold. Cached per process (the
    cases run several steps on one preset); callers copy, never write."""
    p = {k: np.asarray(v) for k, v in init_params(cfg, seed=0).items()}
    rng = np.random.RandomState(11)
    for name, v in p.items():
        if name.endswith("_bn_s"):
            p[name] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
        elif name.endswith("_bn_b") or name.endswith("_b"):
            p[name] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    if mask_bias:
        p["mask_fcn_logits_b"] = np.where(np.arange(cfg.num_classes) % 2, -3.0, 3.0
                                          ).astype(np.float32)
    return p


class FixedUniforms:
    """An injected ``uniforms`` of the e2e step: the arrays (B, n) of step
    0's global batch, as a single process is given them."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __call__(self, step, batch_size, n_anchors, n_cand, device):
        assert step == 0 and all(v.shape == (batch_size, n_anchors if k.startswith("anchor")
                                               else n_cand) for k, v in self.arrays.items())
        return {k: torch.from_numpy(v).to(device) for k, v in self.arrays.items()}


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _rows(mesh, batch):
    """This rank's rows of a numpy batch dict, as tensors; all of it
    without a mesh (world 1)."""
    from detectorch_tpu_torch.parallel.mesh import shard_batch

    if mesh is None:
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return dict(zip(batch, shard_batch(mesh, *batch.values())))


def host_sampled_step(mesh, cfg_name, batch, train_mask):
    """One step of ``make_train_step`` on this rank's rows (mesh None:
    one process, the whole batch); returns the metrics and the unsharded
    checkpoint (params and optimizer state)."""
    from detectorch_tpu_torch.train.train_step import make_train_step, state_dict

    cfg = cfg_of(cfg_name)
    init_state, make_step = make_train_step(cfg, SOLVER, train_mask=train_mask,
                                            roi_align_impl="pallas-slab", mesh=mesh)
    state, opt = init_state(params_from_jax(case_params(cfg)))
    state, metrics = make_step(opt)(state, _rows(mesh, batch))
    saved = state_dict(state, mesh)  # a collective: every rank gathers
    out = {"metrics": _floats(metrics), "sharded": list(state.sharded),
           "local_fc6_rows": int(state.params["fc6_w"].shape[0])}
    if mesh is None or mesh.rank == 0:  # one copy of the checkpoint is enough
        out.update(params=to_host(saved["params"]),
                   momentum={i: s["momentum_buffer"].numpy()
                             for i, s in saved["optimizer"]["state"].items()})
    return out


def image_mean_grads(cfg_name, batch, train_mask):
    """World 1 without batching: the gradient of each image's loss alone,
    averaged over the images, for the trainable leaves (by name): what the
    data ranks' all-reduced mean computes, rounded as one process rounds
    it."""
    from detectorch_tpu_torch.train.train_step import box_branch_loss, make_init_state

    cfg = cfg_of(cfg_name)
    keys = ["image", "rois", "labels", "bbox_targets", "bbox_inside_weights",
            "bbox_outside_weights", "valid"] + (["mask_targets", "mask_valid"] if train_mask
                                                else [])
    extra = {"kp_labels", "kp_valid"} & set(batch)
    total = None
    for i in range(len(batch["image"])):
        state, _ = make_init_state(SOLVER)(params_from_jax(case_params(cfg)))
        rows = {k: torch.from_numpy(batch[k][i:i + 1]) for k in keys + sorted(extra)}
        loss, _ = box_branch_loss(state.params, cfg, *(rows[k] for k in keys),
                                  **{k: rows[k] for k in extra})
        loss.mean().backward()
        g = {k: v.grad.numpy() for k, v in state.params.items() if v.grad is not None}
        total = g if total is None else {k: total[k] + g[k] for k in total}
    return {k: v / len(batch["image"]) for k, v in total.items()}


def e2e_step(mesh, batch, uniforms, pre, post, rois_per_image, seed):
    """The e2e Mask R-CNN step on this rank's rows with the global batch's
    uniforms injected: this rank's sampled rois (``e2e_losses`` with
    ``rank_uniforms``, as the step draws them) and the step's metrics."""
    from detectorch_tpu_torch.config import SamplerConfig
    from detectorch_tpu_torch.train import e2e as E

    cfg = cfg_of("mask")
    sampler = SamplerConfig(rois_per_image=rois_per_image)
    draw = FixedUniforms(uniforms)
    init_state, make_step = E.make_e2e_train_step(
        cfg, SOLVER, sampler, seed=seed, train_pre_nms=pre, train_post_nms=post,
        train_mask=True, roi_align_impl="pallas-slab", uniforms=draw, mesh=mesh)
    state, opt = init_state(params_from_jax(case_params(cfg)))
    rows = _rows(mesh, batch)
    bsz, ranks, rank = rows["image"].shape[0], mesh.shape["data"], mesh.coords["data"]
    rank_draw = E.rank_uniforms(draw, seed)
    with torch.no_grad():
        _, _, sampled = E.e2e_losses(
            state.params, cfg, sampler, rows["image"], rows["gt_boxes"], rows["gt_classes"],
            rows["gt_valid"], rows["info"],
            lambda na, nc: rank_draw(0, rank * bsz, bsz, ranks * bsz, na, nc, "cpu"),
            train_pre_nms=pre, train_post_nms=post,
            extras={"gt_masks": rows["gt_masks"], "gt_mask_valid": rows["gt_mask_valid"]},
            mesh=mesh)
    _, metrics = make_step(opt)(state, rows)
    return {"sampled": to_host(sampled), "metrics": _floats(metrics)}


def inference(mesh, images, scalars, test_cfg):
    """``make_batched_inference_fn`` on this rank's rows: the global
    batch's outputs (mesh None: ``make_inference_fn`` on the whole batch)."""
    from detectorch_tpu_torch.models.detector import make_inference_fn
    from detectorch_tpu_torch.parallel.mesh import (
        make_batched_inference_fn,
        shard_batch,
        shard_params,
    )

    cfg = cfg_of("mask_small_rpn")
    params = params_from_jax(case_params(cfg))
    if mesh is None:
        out = make_inference_fn(cfg, test_cfg)(
            params, *(torch.from_numpy(a) for a in (images, *scalars)))
    else:
        out = make_batched_inference_fn(cfg, test_cfg, mesh)(
            shard_params(params, mesh), *shard_batch(mesh, images, *scalars))
    return to_host(out)


def evaluate(mesh, ann, imdir, test_cfg, batch_size):
    """``evaluate_dataset`` on the mesh: the results and stats every rank
    gets."""
    from detectorch_tpu_torch.data.coco import CocoDataset
    from detectorch_tpu_torch.eval.engine import evaluate_dataset

    cfg = cfg_of("mask_small_rpn")
    bbox, segm, info = evaluate_dataset(
        cfg, test_cfg, params_from_jax(case_params(cfg, mask_bias=True)),
        CocoDataset(ann, imdir), verbose=False, batch_size=batch_size, mesh=mesh,
        device="cpu")
    return {"bbox_stats": bbox, "segm_stats": segm, "bbox": info["bbox"],
            "segm": info["segm"]}


def train(mesh, argv):
    """``tools/train_fast.main(argv)`` on this rank, in the process group
    the rank already joined (the trainer makes its own mesh over it)."""
    from detectorch_tpu_torch.tools import train_fast

    train_fast.main(argv)


def rank_job(cases):
    """Run `cases` [(name, function name, mesh (data, model), kwargs)] on
    this rank, in order; returns {name: result}."""
    from detectorch_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for name, fn, (data, model), kwargs in cases:
        mesh = make_mesh(data, model, device="cpu")
        out[name] = globals()[fn](mesh, **kwargs)
    return out


def leak_check_rank():
    """The parallel paths in a rank: meshes (2, 1) and (1, 2), the bucketed
    mean, the row gather, the column-parallel product and its backward, the
    host objects' gather, and the modules of the multi-rank trainer, eval
    and dry run imported. Returns the modules of jax or of the JAX package
    that this rank's interpreter holds (none)."""
    import sys

    import detectorch_tpu_torch.eval.engine  # noqa: F401
    import detectorch_tpu_torch.parallel.dryrun  # noqa: F401
    import detectorch_tpu_torch.tools.train_fast  # noqa: F401
    from detectorch_tpu_torch.parallel import mesh as M

    for data, model in ((2, 1), (1, 2)):
        mesh = M.make_mesh(data, model, device="cpu")
        M.all_reduce_mean([torch.ones(3)], mesh, None)
        M.gather_batch({"x": torch.ones(1, 2)}, mesh)
        x = torch.ones(2, 4, requires_grad=True)
        M.column_parallel(x, mesh, lambda xs: xs @ torch.ones(4, 2 // model)).sum().backward()
        M.all_gather_objects({"rank": mesh.rank}, mesh)
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "detectorch_tpu"))
