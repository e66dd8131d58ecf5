"""The port's parallel execution (``detectorch_tpu_torch/parallel``) at
world 2 against world 1, and against JAX's sharded tests' semantics.

Two ranks run on the gloo backend on the CPU (``parallel.launch.run_ranks``:
``spawn`` processes, a ``file://`` rendezvous under the test's temporary
directory, one torch thread each); the cases they run live in the JAX-free
tests/torch_dist_case.py. One job of two ranks runs every case of this
file; each test holds one case to world 1, the port in this process on the
whole batch, or to JAX.

Tolerances, fp32:
  * selections (sampled labels, validity, gt indices; detection classes;
    roi validity) exactly;
  * losses and metrics: rtol 2e-4, atol 1e-6, JAX's own sharded tests'
    bound (tests/test_parallel.py): a mean of rank means rounds apart from
    one mean over the batch;
  * the update of one step (p1 - p0) and the momentum, per trainable
    leaf: ||d|| <= 5e-3 ||update|| (plus 3 ulp of the leaf's largest value
    per element for the stored params) and cosine >= 0.9999; frozen leaves
    do not move. That is tests/test_torch_train.py's bound for a batch's
    gradient against the mean of its images' own: oneDNN blocks a
    convolution's sums by the batch, and the mask head's weight gradients
    are sums that cancel. One process that runs the two images one at a
    time rounds _[mask]_fcn1_w's gradient 1.17e-3 (in norm) apart from one
    that runs both at once, as far as world 2 does (the losses are bitwise
    equal). So the data mean is also held, within 1e-5 in norm, to that
    one-at-a-time mean (``torch_dist_case.image_mean_grads``);
  * against JAX (the e2e step with JAX's uniforms): the sampled rois within
    tests/torch_e2e_case.ROI_ATOL, losses rtol 2e-4 and atol 1e-5 (the
    world-1 port-vs-JAX tests' 1e-4, doubled for the rank mean);
  * the keypoint step at model 2 against JAX's on its (data 1, model 2)
    mesh of virtual devices: losses rtol 2e-4 and atol 1e-5, the update and
    the momentum by the norm and cosine bound above;
  * the trainer (``train_fast`` on two ranks against one process): its
    first step's momentum by the norm and cosine bound, its params within
    2 ulp plus 5e-3 of the leaf's update;
  * inference: ``parallel.dryrun.compare_outputs`` (scores rtol 1e-4 atol
    1e-5, boxes rtol 1e-4 atol 5e-3, masks rtol 1e-3 atol 1e-4; near-tied
    detection slots paired in either order), JAX's dry run's tolerances;
  * evaluation: the same results in the same order, boxes and scores
    within 1e-4, mask RLEs equal (masks biased +-3 away from the 0.5
    threshold), COCO stats within 1e-6.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests import torch_dist_case as dc
from tests import torch_e2e_case as case
from tests.test_torch_kp_train import kp_batch
from tests.test_torch_train import _batch as host_batch
from detectorch_tpu_torch.checkpoint import store
from detectorch_tpu_torch.config import PRESETS, TestConfig
from detectorch_tpu_torch.parallel import mesh as M
from detectorch_tpu_torch.parallel.dryrun import compare_outputs
from detectorch_tpu_torch.parallel.launch import run_ranks
from detectorch_tpu_torch.tools import train_fast

LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
INFER_TCFG = TestConfig(detections_per_img=5, score_thresh=0.0)
EVAL_TCFG = TestConfig(target_size=64, max_size=96, detections_per_img=5, score_thresh=0.0,
                       exact_blob_dims=True)
EVAL_IMAGES = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six pytest workers share the CPU: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _e2e_uniforms():
    """JAX's step-0 uniforms of the e2e case's two images: anchors of the
    64x128 blob over P2..P6, 3 aspect ratios each, and post + gt slots."""
    n_anchors = 3 * sum((case.H >> lvl) * (case.W >> lvl) for lvl in range(2, 7))
    u = case.jax_uniforms()(0, case.B, n_anchors, case.POST + case.G, "cpu")
    return {k: v.numpy() for k, v in u.items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from detectorch_tpu_torch.data.synth import build_synth_coco

    root = tmp_path_factory.mktemp("parallel")
    ann, imdir = build_synth_coco(str(root / "synth"), n_images=EVAL_IMAGES, height=64,
                                  width=96, seed=3)
    train_ds = build_synth_coco(str(root / "train"), n_images=3, height=60, width=90, seed=9)
    rng = np.random.RandomState(5)
    images = (rng.randn(2, 64, 96, 3) * 30).astype(np.float32)
    scalars = [np.full(2, v, np.float32) for v in (1.0, 64.0, 96.0)]
    kp = kp_batch(1, dc.cfg_of("kp").num_classes)
    return {
        "fpn_mask": ("host_sampled_step", dict(cfg_name="mask",
                                               batch=host_batch(1, 81, True), train_mask=True)),
        "kp": ("host_sampled_step", dict(cfg_name="kp", batch=kp, train_mask=False)),
        "e2e": ("e2e_step", dict(batch=case.make_batch(1, True, False),
                                 uniforms=_e2e_uniforms(), pre=case.PRE, post=case.POST,
                                 rois_per_image=32, seed=case.SEED)),
        "infer": ("inference", dict(images=images, scalars=scalars, test_cfg=INFER_TCFG)),
        "eval": ("evaluate", dict(ann=ann, imdir=imdir, test_cfg=EVAL_TCFG, batch_size=2)),
        # train_fast on two ranks, global batch 2, for 2 iterations
        "train": ("train", dict(argv=_train_argv(*train_ds, str(root / "two"),
                                                 "--max-iter", "2"))),
    }


def _train_argv(ann, imdir, out, *flags):
    return ["--ann", ann, "--imdir", imdir, "--fpn", "--e2e", "--masks", "--out", out,
            "--checkpoint-period", "1", "--log-period", "1", "--base-lr", "0.001",
            "--target-size", "64", "--max-size", "96", "--blob", "64", "96",
            "--rois-per-image", "16", "--device", "cpu", *flags]


# (case, mesh (data, model)) run by the two ranks
WORLD2 = [("fpn_mask", (2, 1)), ("kp", (1, 2)), ("e2e", (2, 1)), ("infer", (2, 1)),
          ("infer", (1, 2)), ("eval", (2, 1)), ("train", (2, 1))]


@pytest.fixture(scope="module")
def world2(inputs):
    """Every case on two ranks, started in the background:
    world2[(case, mesh)] waits for the job and gives [rank 0's result,
    rank 1's]. ``world2.jax`` holds JAX's references, computed here while
    the ranks run: the e2e case's sample and step-0 metrics, and the
    keypoint case's step on JAX's (data 1, model 2) mesh."""
    cases = [(f"{name}-{shape}", inputs[name][0], shape, inputs[name][1])
             for name, shape in WORLD2]
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(run_ranks, dc.rank_job, 2, (cases,), timeout_s=600)

        class Results(dict):
            def __missing__(self, key):
                ranks = job.result()
                name, shape = key
                return [r[f"{name}-{shape}"] for r in ranks]

        results = Results()
        cfg, pcfg = case.cfgs(dc.MASK, compute_dtype="float32")
        params = dc.case_params(pcfg)
        batch = inputs["e2e"][1]["batch"]
        results.jax = {"e2e_metrics": _jax_step0_metrics(cfg, params, batch),
                       "e2e_sampled": case.jax_sampled(cfg, params, batch["image"], batch),
                       "kp": _jax_kp_step_model2(inputs["kp"][1]["batch"])}
        yield results


def world1(inputs, name):
    fn, kwargs = inputs[name]
    return getattr(dc, fn)(None, **kwargs)


def test_init_distributed_from_env_noop(monkeypatch):
    # one process, no torchrun environment: a no-op, as JAX's hook is
    # without a coordinator; torch stays usable and no group exists
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert M.init_distributed_from_env() is False
    assert not torch.distributed.is_initialized()
    mesh = M.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is None
    t = torch.ones(3)
    M.all_reduce_mean([t], mesh)
    assert torch.equal(t, torch.ones(3))
    with pytest.raises(ValueError):
        M.make_mesh(data_parallel=2, device="cpu")


def test_param_sharding_matches_jax_rule():
    """Which leaves shard over 'model', and each model rank's rows: JAX's
    ``param_sharding`` on its 4 x 2 mesh of virtual devices against the
    port's on a 4 x 2 mesh shape."""
    import jax

    from detectorch_tpu.parallel import mesh as JM

    cfg = dc.cfg_of("mask")
    params = dc.case_params(cfg)
    jspecs = {k: tuple(s.spec) for k, s in
              JM.param_sharding(params, JM.make_mesh(jax.devices()[:8], 4, 2)).items()}
    specs = M.param_sharding(params, M.Mesh(4, 2, "cpu"))
    assert specs == jspecs
    assert {k for k, s in specs.items() if s} == {"fc6_w", "fc6_b", "fc7_w", "fc7_b"}
    assert specs["fc6_w"] == ("model", None) and specs["fc6_b"] == ("model",)
    assert not any(M.param_sharding(params, M.Mesh(8, 1, "cpu")).values())
    # model rank j holds rows [j * 512, (j + 1) * 512) of fc6/fc7's 1024
    full = {k: torch.from_numpy(params[k]) for k in ("fc6_w", "fc6_b", "conv1_w")}
    for j in range(2):
        mesh = M.Mesh(1, 2, "cpu")
        mesh.coords = {"data": 0, "model": j}
        mine = M.shard_params(full, mesh)
        assert torch.equal(mine["fc6_w"], full["fc6_w"][j * 512:(j + 1) * 512])
        assert torch.equal(mine["fc6_b"], full["fc6_b"][j * 512:(j + 1) * 512])
        assert torch.equal(mine["conv1_w"], full["conv1_w"])


def test_train_fast_two_ranks_resumes_at_world1(inputs, world2, tmp_path, capsys):
    """``train_fast --fpn --e2e --masks`` on two ranks, global batch 2, for 2
    iterations: its first step is the one-process step on the same batch
    (the same images and uniforms, the gradients averaged over the ranks),
    and one process resumes its ckpt-2 for a third iteration."""
    argv = inputs["train"][1]["argv"]
    ann, imdir, two = (argv[argv.index(f) + 1] for f in ("--ann", "--imdir", "--out"))
    one = str(tmp_path / "one")
    train_fast.main(_train_argv(ann, imdir, one, "--max-iter", "1", "--batch-size", "2"))
    world2[("train", (2, 1))]  # the two ranks' run has ended
    got = store.restore_checkpoint(os.path.join(two, "ckpt-1"))
    exp = store.restore_checkpoint(os.path.join(one, "ckpt-1"))
    # the gradient the step applied (its momentum) within the bound; the
    # params, whose update (lr 3.3e-4 in warm-up) lies near their fp32
    # spacing, each within 2 ulp of the leaf's largest value plus 5e-3 of
    # its largest update
    states = [c["optimizer"]["state"] for c in (got, exp)]
    assert states[0].keys() == states[1].keys() and len(states[0]) > 80
    for i in states[1]:
        _close_norm(f"momentum {i}", *(s[i]["momentum_buffer"].numpy() for s in states))
    p0 = _train_fast_init()
    moved = 0
    for k, v in exp["params"].items():
        v, update = v.numpy(), np.abs(v.numpy() - p0[k]).max()
        moved += update > 0
        np.testing.assert_allclose(got["params"][k].numpy(), v, rtol=0, err_msg=k,
                                   atol=2 * np.spacing(np.abs(v).max()) + 5e-3 * update)
    assert moved > 80
    assert os.path.exists(os.path.join(two, "ckpt-2"))

    capsys.readouterr()
    train_fast.main(_train_argv(ann, imdir, two, "--max-iter", "3", "--resume"))
    out = capsys.readouterr().out
    assert f"resumed from {os.path.join(two, 'ckpt-2')} at iter 2" in out
    assert out.count("json_stats") == 1 and "global batch 1 over 1 rank(s)" in out
    assert os.path.exists(os.path.join(two, "ckpt-3"))


def _train_fast_init():
    """The trainer's initial params (``init_params(seed 3)``), port layout."""
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax
    from detectorch_tpu_torch.models.detector import init_params

    params = params_from_jax(init_params(PRESETS["e2e_mask_rcnn_R-50-FPN_2x"], seed=3))
    return {k: v.numpy() for k, v in params.items()}


def test_e2e_step_world2_with_jax_uniforms_equals_jax(world2):
    """The e2e Mask R-CNN step at world 2 with JAX's uniforms injected
    against JAX's single-device e2e step: each rank's sampled set row for
    row against JAX's sample of its global image, then the global step's
    losses against the metrics of JAX's step 0 (``_jax_step0_metrics``)."""
    jax_metrics, jax_sampled = world2.jax["e2e_metrics"], world2.jax["e2e_sampled"]
    for rank, got in enumerate(world2[("e2e", (2, 1))]):
        s, e = got["sampled"], jax_sampled[rank]
        np.testing.assert_array_equal(s["labels"][0], e.labels)
        np.testing.assert_array_equal(s["valid"][0], e.valid)
        np.testing.assert_array_equal(s["gt_inds"][0][e.valid], e.gt_inds[e.valid])
        np.testing.assert_allclose(s["rois"][0], e.rois, rtol=0, atol=case.ROI_ATOL)
        assert (e.labels > 0).sum() >= 2
        for k in ("loss", "loss_cls", "loss_bbox", "loss_rpn_cls", "loss_rpn_bbox",
                  "loss_mask", "accuracy"):
            np.testing.assert_allclose(got["metrics"][k], jax_metrics[k], rtol=2e-4,
                                       atol=1e-5, err_msg=k)


def _jax_step0_metrics(cfg, params, batch):
    """The metrics of step 0 of JAX's ``make_e2e_train_step`` (its forward
    alone: the mean over the images of ``e2e_losses`` with the step's
    per-image keys, fold_in(PRNGKey(seed), 0) split per image), without
    compiling its backward."""
    import jax
    import jax.numpy as jnp

    from detectorch_tpu.train import e2e as JE

    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(case.SEED), 0), case.B)

    @jax.jit
    def forward(params, images, gt_boxes, gt_classes, gt_valid, info, keys, masks, mvalid):
        def one(image, boxes, classes, valid, inf, key, mask, mv):
            return JE.e2e_losses(params, cfg, case.SAMPLER, image, boxes, classes, valid, inf,
                                 key, train_pre_nms=case.PRE, train_post_nms=case.POST,
                                 extras={"gt_masks": mask, "gt_mask_valid": mv})

        total, metrics = jax.vmap(one)(images, gt_boxes, gt_classes, gt_valid, info, keys,
                                       masks, mvalid)
        return dict(jax.tree.map(jnp.mean, metrics), loss=jnp.mean(total))

    out = forward(params, *(batch[k] for k in ("image", "gt_boxes", "gt_classes", "gt_valid",
                                               "info")), keys, batch["gt_masks"],
                  batch["gt_mask_valid"])
    return {k: float(v) for k, v in out.items()}


def _jax_kp_step_model2(batch):
    """One step of JAX's ``make_train_step`` for the keypoint case on JAX's
    mesh of two virtual devices, data 1 x model 2 (``shard_params`` splits
    fc6/fc7's rows over 'model', the batch goes over 'data'), as JAX's
    test_keypoint_train_step_sharded_equals_single runs its sharded step:
    the metrics, and the params after the step and the momentum (optax's
    trace) by leaf name, in the port's layout."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from detectorch_tpu.config import SolverConfig
    from detectorch_tpu.parallel import mesh as JM
    from detectorch_tpu.train.train_step import make_train_step
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax
    from tests.test_torch_kp_train import kp_cfgs
    from tests.test_torch_train import _jax_trace

    cfg, _ = kp_cfgs(compute_dtype="float32")
    solver = SolverConfig(base_lr=dc.SOLVER.base_lr, warmup_iters=dc.SOLVER.warmup_iters)
    mesh = JM.make_mesh(jax.devices()[:2], 1, 2)
    init_state, make_step = make_train_step(cfg, solver)
    state, tx = init_state(dc.case_params(dc.cfg_of("kp")))
    state = state._replace(params=JM.shard_params(state.params, mesh))
    assert state.params["fc6_w"].sharding.spec == P("model", None)
    rows = NamedSharding(mesh, P("data"))
    state, metrics = jax.jit(make_step(tx))(
        state, {k: jax.device_put(v, rows) for k, v in batch.items()})

    def port(tree):
        return {k: v.numpy() for k, v in
                params_from_jax({k: np.array(v) for k, v in tree.items()}).items()}

    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": port(state.params), "momentum_of": port(_jax_trace(state.opt_state))}


def _close_norm(name, got, exp, rel=5e-3, floor=0.0):
    """||got - exp|| <= rel ||exp|| + floor * sqrt(size), cosine >= 0.9999."""
    got, exp = np.asarray(got, np.float64).ravel(), np.asarray(exp, np.float64).ravel()
    norm = np.linalg.norm(exp)
    if norm == 0:
        assert not got.any(), name
        return
    err = np.linalg.norm(got - exp)
    assert err <= rel * norm + floor * np.sqrt(exp.size), (name, err / norm)
    assert got @ exp / (np.linalg.norm(got) * norm) >= 0.9999, name


def _close_step(got, exp, p0):
    """A world-2 step's metrics, the update it made (p1 - p0) and its
    momentum against world 1's; frozen leaves stay put."""
    for k, v in exp["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **LOSS_TOL)
    assert got["params"].keys() == exp["params"].keys()
    for k, v in exp["params"].items():
        if k in exp["momentum_of"]:
            ulps = 3 * np.spacing(np.abs(p0[k]).max())
            _close_norm(k, got["params"][k] - p0[k], v - p0[k], floor=ulps)
            _close_norm(f"momentum of {k}", got["momentum_of"][k], exp["momentum_of"][k])
        else:
            assert np.array_equal(got["params"][k], p0[k]) and np.array_equal(v, p0[k]), k


def _params0(cfg_name):
    """The cases' params before the step, in the port's layout, as numpy."""
    from detectorch_tpu_torch.checkpoint.convert import params_from_jax

    return {k: v.numpy() for k, v in
            params_from_jax(dc.case_params(dc.cfg_of(cfg_name))).items()}


def _with_names(result):
    """Momentum by leaf name: the optimizer's indices follow the trainable
    leaves in the params' order."""
    from detectorch_tpu_torch.train.solver import frozen_mask

    names = [k for k, t in frozen_mask(result["params"]).items() if t]
    result["momentum_of"] = {names[i]: v for i, v in result["momentum"].items()}
    return result


def test_host_sampled_fpn_step_world2_equals_world1(inputs, world2):
    """The Mask R-CNN FPN step on host-sampled rois, data 2 (one image per
    rank) against one process on both: the same global step."""
    exp = _with_names(world1(inputs, "fpn_mask"))
    ranks = world2[("fpn_mask", (2, 1))]
    assert all(got["sharded"] == [] and got["local_fc6_rows"] == 1024 for got in ranks)
    got = _with_names(ranks[0])
    p0 = _params0("mask")
    _close_step(got, exp, p0)
    # the data mean itself: the momentum of the first step is the mean of
    # the per-image gradients plus weight decay (the clip is idle at this
    # norm), which one process rounds as the all-reduce does
    kwargs = inputs["fpn_mask"][1]
    mean = dc.image_mean_grads("mask", kwargs["batch"], kwargs["train_mask"])
    assert set(mean) <= set(got["momentum_of"])  # the RPN head: no gradient here
    wd = np.float32(dc.SOLVER.weight_decay)
    for k, m in got["momentum_of"].items():
        _close_norm(k, m, mean.get(k, 0) + wd * p0[k], rel=1e-5)
    assert exp["metrics"]["loss_mask"] > 0


def test_keypoint_step_model2_equals_world1(inputs, world2):
    """JAX's test_keypoint_train_step_sharded_equals_single case on the
    model axis: fc6/fc7 split over 'model' 2, the keypoint preset's step
    (box and keypoint branches) equal to one process; the checkpoint each
    rank writes (``state_dict``: rows gathered) is world 1's."""
    exp = _with_names(world1(inputs, "kp"))
    ranks = world2[("kp", (1, 2))]
    assert all(got["sharded"] == ["fc6_w", "fc6_b", "fc7_w", "fc7_b"]
               and got["local_fc6_rows"] == 512 for got in ranks)
    _close_step(_with_names(ranks[0]), exp, _params0("kp"))
    assert exp["metrics"]["loss_kps"] > 0


def test_keypoint_step_model2_equals_jax_sharded(world2):
    """The keypoint step at model 2 against JAX's step on its own (data 1,
    model 2) mesh, fc6/fc7 sharded by JAX's ``shard_params``: the losses,
    and each trainable leaf's update and momentum."""
    got = _with_names(world2[("kp", (1, 2))][0])
    exp = world2.jax["kp"]
    for k in ("loss", "loss_cls", "loss_bbox", "loss_kps", "accuracy"):
        np.testing.assert_allclose(got["metrics"][k], exp["metrics"][k], rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    p0 = _params0("kp")
    assert got["params"].keys() == exp["params"].keys()
    for k, m in got["momentum_of"].items():
        ulps = 3 * np.spacing(np.abs(p0[k]).max())
        _close_norm(k, got["params"][k] - p0[k], exp["params"][k] - p0[k], floor=ulps)
        _close_norm(f"momentum of {k}", m, exp["momentum_of"][k])
    assert exp["metrics"]["loss_kps"] > 0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["data2", "model2"])
def test_batched_inference_fn_equals_single_rank(inputs, world2, shape):
    """``make_batched_inference_fn`` with data 2 (an image per rank) and
    with model 2 (fc6/fc7 split): every rank gets both images' outputs,
    equal to one process's on the whole batch."""
    exp = world1(inputs, "infer")
    for got in world2[("infer", shape)]:
        for i in range(2):
            assert compare_outputs(got, exp, i, i)["detections"] >= \
                INFER_TCFG.detections_per_img - 1


def test_evaluate_dataset_world2_equals_world1(inputs, world2):
    """``evaluate_dataset(mesh)`` at data 2, global batch 2 (one image per
    rank per batch) over 4 data/synth images, against one process at batch
    2: both ranks get world 1's results in world 1's order."""
    exp = world1(inputs, "eval")
    assert len(exp["bbox"]) == EVAL_IMAGES * EVAL_TCFG.detections_per_img
    for got in world2[("eval", (2, 1))]:
        for kind in ("bbox", "segm"):
            assert len(got[kind]) == len(exp[kind])
            for a, b in zip(got[kind], exp[kind]):
                assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
                np.testing.assert_allclose(a["score"], b["score"], rtol=0, atol=1e-4)
                if kind == "bbox":
                    np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-4)
                else:
                    assert a["segmentation"] == b["segmentation"]
        for k in ("bbox_stats", "segm_stats"):
            np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=1e-6)
