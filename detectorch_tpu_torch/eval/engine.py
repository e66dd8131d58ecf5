"""Dataset-level inference and COCO evaluation.

Port of ``detectorch_tpu/eval/engine.py`` (the reference's eval notebooks
and ``json_dataset_evaluator.py:40-235``): run the model over a dataset,
collect COCO results (bbox xywh with the +1 width convention, segm RLE
strings, keypoints [x, y, 1] per keypoint) and score them with the numpy
COCOeval (``eval/coco_eval``, OKS for keypoints).

  * ``InferenceEngine``: one image at a time; host-blob or
    device-preprocess input; multi-scale inference (``run_image_multiscale``).
  * ``BatchedInferenceEngine``: bucket-grouped batches, the tail batch
    padded by repeating its last sample; one packed (B, K, 8) detections
    tensor, one mask tensor (bf16 unless ``mask_fetch_dtype`` says
    float32) and one fp32 keypoint tensor fetched per batch; masks pasted on the calling thread (a
    4-thread pool, as the JAX engine has, was twice as slow on the card's
    host).
  * ``evaluate_dataset``: the loop, with a prefetching loader and a 1-deep
    (single) or 2-deep (batched) submit/finalize pipeline; on a mesh
    (``parallel.mesh``) every rank plans the same batches and runs its data
    rows of each, and the results are gathered on every rank.

Preprocessing (``preprocess``) is host numpy only and runs in the loader's
threads; every host-to-device copy and every CUDA call happens on the
calling thread. PyTorch runs eagerly, so a "program" here is a Python
closure kept per sample key; none is compiled. RoIAlign is exact for every
roi, so of the JAX engine's exact rerun only the NMS-prefilter half remains
(``all_exact`` is ``nms_exact``). The NMS fixpoint syncs with the host,
so ``submit`` returns only when the device is nearly done: the 2-deep
pipeline keeps its structure but overlaps little.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from detectorch_tpu_torch.checkpoint.convert import params_to_device
from detectorch_tpu_torch.config import ModelConfig, TestConfig
from detectorch_tpu_torch.data import transforms as T
from detectorch_tpu_torch.data.coco import CocoDataset, RoidbEntry
from detectorch_tpu_torch.data.device_input import (
    RAW_STRIDE,
    device_preprocess,
    pack_tables_meta,
    prepare_raw,
)
from detectorch_tpu_torch.eval import mask_paste
from detectorch_tpu_torch.eval import postprocess as pp
from detectorch_tpu_torch.eval.coco_eval import COCOeval
from detectorch_tpu_torch.models.detector import (
    make_inference_fn,
    make_keypoint_fn,
    make_mask_fn,
)
from detectorch_tpu_torch.parallel import mesh as par


def detections_to_coco_bbox(det_boxes, det_scores, det_classes, image_id, contiguous_to_json):
    """xyxy -> xywh with the +1 convention (reference
    json_dataset_evaluator.py:165-190 via boxes.xyxy_to_xywh)."""
    out = []
    for box, score, cls in zip(det_boxes, det_scores, det_classes):
        x1, y1, x2, y2 = [float(v) for v in box]
        out.append({
            "image_id": int(image_id),
            "category_id": int(contiguous_to_json[int(cls)]),
            "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
            "score": float(score),
        })
    return out


def detections_to_coco_keypoints(keypoints, det_scores, det_classes, image_id,
                                 contiguous_to_json, confidence: str = "bbox"):
    """(k, P, 4) decoded keypoints -> COCO keypoint results: [x, y, v=1] per
    keypoint, scored by the detection ('bbox') or by the mean logit or
    probability over the keypoints (reference
    json_dataset_evaluator.py:371-417, whose rows are the (4, P)
    transpose)."""
    cols = {"bbox": None, "logit": 2, "prob": 3}
    if confidence not in cols:
        raise ValueError("keypoint_confidence must be 'bbox', 'logit', or 'prob'")
    score_col = cols[confidence]
    out = []
    for kp, det_score, cls in zip(keypoints, det_scores, det_classes):
        xyv = np.concatenate([kp[:, :2], np.ones((kp.shape[0], 1), kp.dtype)], axis=1)
        score = float(det_score) if score_col is None else float(kp[:, score_col].mean())
        out.append({
            "image_id": int(image_id),
            "category_id": int(contiguous_to_json[int(cls)]),
            "keypoints": [float(v) for v in xyv.reshape(-1)],
            "score": score,
        })
    return out


class InferenceEngine:
    """Single-image inference. `params` are port-layout tensors
    (``checkpoint.convert``, ``checkpoint.caffe2_import``), moved to
    `device` once; with a `mesh`, this rank's shard of them
    (``parallel.mesh.shard_params``), fc6/fc7 running column-parallel."""

    def __init__(self, cfg: ModelConfig, test_cfg: TestConfig, params: Dict,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.test_cfg = test_cfg
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            params = par.shard_params(params, mesh)
        self.params = params_to_device(params, self.device)
        self._compiled: Dict = {}

    # -- programs ------------------------------------------------------------

    def _pad_stride(self):
        return self.cfg.fpn.coarsest_stride if self.cfg.use_fpn else 32

    def _buckets(self):
        return None if self.test_cfg.exact_blob_dims else T.DEFAULT_BUCKETS

    def sample_key(self, args):
        """The shapes a preprocessed sample's program is specialised on: the
        blob shape (host mode), or (raw bucket, output bucket) with the
        output bucket recomputed from meta's resized dims (device mode)."""
        if not self.test_cfg.device_preprocess:
            return tuple(args[0].shape)
        meta = args[2]
        return (tuple(args[0].shape),
                T.bucket_shape(int(meta[2]), int(meta[3]), self._pad_stride(), self._buckets()))

    def key_of_dims(self, h: int, w: int):
        """The sample key of an h x w image, from its size alone: what
        ``sample_key(preprocess(image)[0])`` gives."""
        ts, max_size = self.test_cfg.target_size, self.test_cfg.max_size
        scale = T.compute_scale(h, w, ts, max_size)
        out = T.bucket_shape(int(np.round(h * scale)), int(np.round(w * scale)),
                             self._pad_stride(), self._buckets())
        if not self.test_cfg.device_preprocess:
            return (*out, 3)
        return ((T.round_up(h, RAW_STRIDE), T.round_up(w, RAW_STRIDE), 3), out)

    def _needs_exact_check(self):
        """True if the program can flag an inexact result that needs the
        full-NMS rerun: the per-class NMS top-M prefilter overflowed."""
        return self.test_cfg.nms_topk_prefilter > 0

    def _wrap_raw(self, fwd, key):
        """Wrap an (params, image, im_scale, orig_h, orig_w, *extra) program
        so that it takes the raw uint8 batch, its (B, 4, L) tables and (B, 7)
        meta (``device_input.pack_tables_meta``) instead of a host blob."""
        (_, (out_h, out_w)) = key

        @torch.inference_mode()
        def raw_fwd(params, raw, tables, meta, *extra):
            image = device_preprocess(raw, tables, meta, out_h, out_w)
            return fwd(params, image, meta[:, 4], meta[:, 5], meta[:, 6], *extra)

        return raw_fwd

    def build_single(self, key, exact: bool = False):
        """The program for this sample key; exact=True without the NMS
        prefilter."""
        tcfg = self.test_cfg.replace(nms_topk_prefilter=0) if exact else self.test_cfg
        fwd = make_inference_fn(self.cfg, tcfg, mesh=self.mesh)
        return self._wrap_raw(fwd, key) if self.test_cfg.device_preprocess else fwd

    def _fn(self, key):
        if key not in self._compiled:
            self._compiled[key] = self.build_single(key)
        return self._compiled[key]

    def _exact_fn(self, key):
        ckey = ("exact", key)
        if ckey not in self._compiled:
            self._compiled[ckey] = self.build_single(key, exact=True)
        return self._compiled[ckey]

    def _mask_fn(self, key):
        ckey = ("mask", key)
        if ckey not in self._compiled:
            mfn = make_mask_fn(self.cfg)
            self._compiled[ckey] = (self._wrap_raw(mfn, key) if self.test_cfg.device_preprocess
                                    else mfn)
        return self._compiled[ckey]

    def _kp_fn(self, key):
        """The keypoint-only program of the multi-scale path."""
        ckey = ("kp", key)
        if ckey not in self._compiled:
            kfn = make_keypoint_fn(self.cfg)
            self._compiled[ckey] = (self._wrap_raw(kfn, key) if self.test_cfg.device_preprocess
                                    else kfn)
        return self._compiled[ckey]

    # -- host side -------------------------------------------------------------

    def preprocess(self, im_rgb: np.ndarray, proposals: Optional[np.ndarray] = None,
                   target_size: Optional[int] = None):
        """Host-side prep -> (args, orig_h, orig_w), args a list of numpy
        arrays: [blob, scale, orig_h, orig_w] (host mode) or [raw, tables,
        meta] (device mode), then [proposals, proposals_valid] in Fast
        R-CNN mode. Thread-safe; touches no tensor. target_size overrides
        test_cfg.target_size (multi-scale inference)."""
        ts = self.test_cfg.target_size if target_size is None else target_size
        if self.test_cfg.device_preprocess:
            raw, m = prepare_raw(im_rgb, ts, self.test_cfg.max_size,
                                 pad_stride=self._pad_stride(), buckets=self._buckets())
            scale, oh, ow = m["scale"], m["orig_h"], m["orig_w"]
            args = [raw, *pack_tables_meta(m)]
        else:
            image, scale, (oh, ow) = T.preprocess_image(
                im_rgb, ts, self.test_cfg.max_size,
                pad_stride=self._pad_stride(), buckets=self._buckets())
            args = [image, np.float32(scale), np.float32(oh), np.float32(ow)]
        if not self.cfg.use_rpn:
            if proposals is None:
                raise ValueError("Fast R-CNN mode needs proposals")
            # spatial_scale (1/16) for FPN presets too, as the JAX engine does
            scaled, _ = T.dedup_proposals(proposals * scale, self.cfg.spatial_scale)
            args += list(T.pad_proposals(scaled, self.test_cfg.max_proposals))
        return args, oh, ow

    def _upload(self, samples_args):
        """Stack the samples' args along a new batch axis and copy each to
        the device: one host-to-device copy per argument."""
        return [torch.from_numpy(np.ascontiguousarray(np.stack([np.asarray(a) for a in arg])))
                .to(self.device) for arg in zip(*samples_args)]

    def _run(self, fn, args):
        """One sample through a program, as a batch of 1."""
        return fn(self.params, *self._upload([args]))

    # -- single image ------------------------------------------------------

    def submit(self, args):
        return self._run(self._fn(self.sample_key(args)), args)

    def finalize(self, out, args, oh, ow):
        """If the NMS prefilter overflowed, rerun the image without it; then
        collect the host-side result."""
        if self._needs_exact_check() and not bool(out.all_exact[0]):
            out = self._run(self._exact_fn(self.sample_key(args)), args)
        return self._collect_dets(out.detections, out.masks, oh, ow, out.keypoints)

    def run_image(self, im_rgb: np.ndarray, proposals: Optional[np.ndarray] = None):
        """One image -> host dict of its final detections (and mask RLEs,
        keypoints)."""
        args, oh, ow = self.preprocess(im_rgb, proposals)
        return self.finalize(self.submit(args), args, oh, ow)

    # -- multi-scale ---------------------------------------------------------

    def _scale_of(self, args) -> float:
        """The im_scale a preprocess() args list was built with."""
        return float(args[2][4] if self.test_cfg.device_preprocess else args[1])

    def _merge_fn(self, nscales: int):
        """The multi-scale merge: decode each scale's pre-NMS candidates to
        original-image coordinates, take their union, and run threshold,
        per-class NMS and the global cap once over it, always without the
        NMS prefilter. merge(scores_l, deltas_l, rois_l, valid_l, scales,
        orig_h, orig_w): per scale (1, N, ...) tensors, scales (S,), orig
        dims (1,)."""
        tcfg = self.test_cfg.replace(nms_topk_prefilter=0)
        num_classes = self.cfg.num_classes

        def merge(scores_l, deltas_l, rois_l, valid_l, scales, orig_h, orig_w):
            preds = [pp.decode_boxes(rois_l[i], deltas_l[i], scales[i:i + 1], orig_h, orig_w,
                                     tcfg) for i in range(nscales)]
            sc = torch.cat([s.float() for s in scores_l], dim=1)
            return pp.postprocess_decoded(sc, torch.cat(preds, dim=1),
                                          torch.cat(valid_l, dim=1), tcfg, num_classes)

        return merge

    def run_image_multiscale(self, im_rgb: np.ndarray, target_sizes,
                             proposals: Optional[np.ndarray] = None):
        """Multi-scale (test-time pyramid) inference with Detectron's
        TEST.BBOX_AUG union semantics, as the JAX engine runs it: the full
        program at each target size, the union of all scales' pre-NMS
        candidates merged once (``_merge_fn``), then the mask and keypoint
        branches once on the merged boxes at target_sizes[0]. With one size
        it reduces to run_image."""
        if len(target_sizes) < 1:
            raise ValueError("need at least one target size")
        per_scale = []
        oh = ow = None
        for ts in target_sizes:
            args, oh, ow = self.preprocess(im_rgb, proposals, target_size=ts)
            per_scale.append((self.submit(args), args))
        f32 = dict(dtype=torch.float32, device=self.device)
        dets = self._merge_fn(len(per_scale))(
            [o.cls_scores for o, _ in per_scale], [o.bbox_deltas for o, _ in per_scale],
            [o.rois for o, _ in per_scale], [o.roi_valid for o, _ in per_scale],
            torch.tensor([self._scale_of(a) for _, a in per_scale], **f32),
            torch.tensor([oh], **f32), torch.tensor([ow], **f32))
        masks = keypoints = None
        args0 = per_scale[0][1]
        base = args0[:3] if self.test_cfg.device_preprocess else args0[:4]
        key0 = self.sample_key(args0)
        if self.cfg.use_mask:
            masks = self._mask_fn(key0)(self.params, *self._upload([base]), dets.boxes,
                                        dets.classes)
        if self.cfg.keypoint is not None:
            keypoints = self._kp_fn(key0)(self.params, *self._upload([base]), dets.boxes)
        return self._collect_dets(dets, masks, oh, ow, keypoints)

    def _collect_dets(self, dets, masks, oh, ow, keypoints=None):
        """Batch-of-1 detections (and masks, keypoints) -> host dict of valid
        rows."""
        valid = dets.valid[0].cpu().numpy()

        def host(t):
            return None if t is None else t[0].float().cpu().numpy()[valid]

        return self._result(host(dets.boxes), host(dets.scores),
                            dets.classes[0].cpu().numpy()[valid], host(masks), oh, ow,
                            host(keypoints))

    def _result(self, boxes, scores, classes, masks, oh, ow, keypoints=None):
        """One image's valid detections as host arrays -> its result dict,
        with the masks pasted and RLE-encoded, and the keypoints, when
        given."""
        result = {"boxes": boxes, "scores": scores, "classes": classes}
        if masks is not None:
            result["rles"] = mask_paste.segm_results(masks, boxes, int(oh), int(ow),
                                                     self.cfg.mask.resolution)
        if keypoints is not None:
            result["keypoints"] = keypoints
        return result


class BatchedInferenceEngine:
    """Bucket-grouped batched inference: one program per sample key, run on
    batches of `batch_size` samples of that key. The throughput path.

    With a `mesh` (``parallel.mesh``), `batch_size` is the global batch:
    each rank runs batches of its batch_size / data samples, its data rows
    of the global batch (``evaluate_dataset`` hands them out), with this
    rank's shard of the params."""

    def __init__(self, cfg: ModelConfig, test_cfg: TestConfig, params: Dict,
                 batch_size: int = 4, mesh=None, device="cuda"):
        self.cfg = cfg
        self.test_cfg = test_cfg
        self.mesh = mesh
        ranks = 1 if mesh is None else mesh.shape["data"]
        if batch_size % ranks:
            raise ValueError(f"batch {batch_size} does not split over {ranks} data ranks")
        self.batch_size = batch_size // ranks
        self._compiled: Dict = {}
        self._single = InferenceEngine(cfg, test_cfg, params, device, mesh)
        self.params = self._single.params  # on the device once (shared)
        # images rerun through the full-NMS program because the NMS
        # prefilter overflowed (diagnostic)
        self.rerun_count = 0

    def _fn(self, key):
        if key not in self._compiled:
            single = self._single.build_single(key)
            needs_check = self._single._needs_exact_check()
            fetch_bf16 = self.test_cfg.mask_fetch_dtype != "float32"

            @torch.inference_mode()
            def packed(params, *batch):
                # the per-detection fields and the per-image exact flag in
                # one tensor: one device-to-host copy (+ the masks) per batch
                out = single(params, *batch)
                d = out.detections
                exact = out.all_exact if needs_check else torch.ones_like(d.valid[:, 0])
                k = d.scores.shape[1]
                pk = torch.cat([
                    d.boxes, d.scores[..., None], d.classes.float()[..., None],
                    d.valid.float()[..., None],
                    exact.float()[:, None, None].expand(-1, k, 1),
                ], dim=-1)  # (B, K, 8)
                masks = out.masks
                if masks is not None and fetch_bf16:
                    # probabilities in [0, 1]: bf16 halves the largest
                    # device-to-host copy; it rounds before the 0.5 threshold
                    masks = masks.to(torch.bfloat16)
                # keypoints stay fp32: (B, K, P, 4) is ~30 KB an image, and
                # bf16 would round x and y by whole pixels
                return pk, masks, out.keypoints

            self._compiled[key] = packed
        return self._compiled[key]

    def preprocess(self, im_rgb, proposals=None):
        return self._single.preprocess(im_rgb, proposals)

    def sample_key(self, args):
        return self._single.sample_key(args)

    def key_of_dims(self, h: int, w: int):
        return self._single.key_of_dims(h, w)

    def submit_batch(self, samples):
        """Run one batch. samples: list of (args, oh, ow) from preprocess(),
        all of one sample key; a short batch is padded by repeating its last
        sample."""
        padded = samples + [samples[-1]] * (self.batch_size - len(samples))
        key = self._single.sample_key(padded[0][0])
        batch = self._single._upload([s[0] for s in padded])
        return self._fn(key)(self.params, *batch)

    def finalize_batch(self, out, samples):
        """Fetch one batch's packed detections, masks and keypoints (one
        device-to-host copy each), rerun any image whose NMS prefilter
        overflowed, and collect the host results (mask paste + RLE, in this
        thread)."""
        n = len(samples)
        pk_dev, masks_dev, kps_dev = out
        pk = pk_dev.cpu().numpy()
        masks = masks_dev.cpu().float().numpy() if masks_dev is not None else None
        kps = kps_dev.cpu().numpy() if kps_dev is not None else None
        boxes = pk[..., :4]
        scores = pk[..., 4]
        classes = pk[..., 5].astype(np.int64)
        valid = pk[..., 6] > 0.5
        exact = pk[:, 0, 7] > 0.5

        def rerun_exact(i):
            # main thread only: it launches device work and bumps a counter
            args, oh, ow = samples[i]
            self.rerun_count += 1
            single = self._single
            out = single._run(single._exact_fn(single.sample_key(args)), args)
            return single._collect_dets(out.detections, out.masks, oh, ow, out.keypoints)

        def collect(i):
            _, oh, ow = samples[i]
            ok = valid[i]
            return self._single._result(boxes[i][ok], scores[i][ok], classes[i][ok],
                                        None if masks is None else masks[i][ok], oh, ow,
                                        None if kps is None else kps[i][ok])

        reruns = {i: rerun_exact(i) for i in range(n) if not bool(exact[i])}
        collected = {i: collect(i) for i in range(n) if i not in reruns}
        collected.update(reruns)
        return [collected[i] for i in range(n)]

    def run_batch(self, samples):
        return self.finalize_batch(self.submit_batch(samples), samples)


def plan_batches(keys, batch_size: int) -> List[List[int]]:
    """The batches of the batched loop, as lists of indices into `keys`
    (each image's sample key): images join their key's bucket in order, a
    full bucket is a batch, and the partial buckets follow in the order
    their keys first came after the last full batch of that key."""
    buckets: Dict[tuple, list] = {}
    batches = []
    for i, key in enumerate(keys):
        buckets.setdefault(key, []).append(i)
        if len(buckets[key]) == batch_size:
            batches.append(buckets.pop(key))
    return batches + list(buckets.values())


def evaluate_dataset(
    cfg: ModelConfig,
    test_cfg: TestConfig,
    params: Dict,
    dataset: CocoDataset,
    roidb: Optional[List[RoidbEntry]] = None,
    limit: Optional[int] = None,
    verbose: bool = True,
    batch_size: int = 1,
    mesh=None,
    output_dir: Optional[str] = None,
    dataset_name: str = "dataset",
    per_class_ap: bool = False,
    engines: Optional[Dict] = None,
    target_sizes: Optional[List[int]] = None,
    load_image: Callable[[str], np.ndarray] = T.load_image_rgb,
    device="cuda",
):
    """Full dataset loop -> (bbox stats, segm stats or None, info).

    `params`: port-layout tensors; `device`: where the model runs.
    `load_image(path)` reads an entry's image as RGB uint8 (default
    ``transforms.load_image_rgb``, which uses cv2). `target_sizes` with
    more than one size switches to multi-scale inference (single-image
    engine only); one size is single-scale eval at that size. `engines`: a
    dict reused across calls to keep engines (and their params on the
    device). With `output_dir`, results round-trip through COCO-format json
    files and the evaluator pickles are saved (``eval.results_io``);
    `per_class_ap` prints the per-category AP table.

    With a `mesh` (``parallel.mesh``, every rank calls this), `batch_size`
    is the global batch: every rank plans the same batches
    (``plan_batches``, from the roidb's image sizes), loads, runs and
    finalizes its data rows of each on `device`, and the results are
    gathered on every rank in the order a single process gives them.

    info holds the COCO results ('bbox', 'segm', 'keypoints'),
    'keypoints_stats' (the 10 OKS stats of a keypoint preset, else None),
    'images_per_sec' (host loading, device work, paste and RLE included) and
    'phase_seconds', the loop's time split into load (waiting on the
    loader), submit and finalize. Keypoint results are scored as
    test_cfg.keypoint_confidence says."""
    if roidb is None:
        roidb = dataset.get_roidb(gt=False)
    if limit:
        roidb = roidb[:limit]

    # a single-element target_sizes is single-scale eval at that size: fold
    # it into test_cfg before the engines are built
    if target_sizes is not None:
        target_sizes = list(target_sizes)
        if len(target_sizes) == 1:
            test_cfg = test_cfg.replace(target_size=target_sizes[0])
            target_sizes = None
    multiscale = target_sizes is not None
    if multiscale and (batch_size > 1 or mesh is not None):
        raise ValueError("multi-scale eval runs the single-image engine (batch_size=1, "
                         "no mesh)")

    from detectorch_tpu_torch.data.loader import PrefetchLoader

    if engines is None:
        engines = {}
    # keyed by target size: a dict warmed at the default size must not serve
    # a single-element target_sizes override
    skey = ("single", test_cfg.target_size)
    if skey not in engines:
        engines[skey] = InferenceEngine(cfg, test_cfg, params, device)
    engine = engines[skey]

    if multiscale:
        def make_sample(entry):
            proposals = entry.boxes if not cfg.use_rpn else None
            return entry, load_image(entry.file_path), proposals
    else:
        def make_sample(entry):
            proposals = entry.boxes if not cfg.use_rpn else None
            args, oh, ow = engine.preprocess(load_image(entry.file_path), proposals)
            return entry, args, oh, ow

    phase_s = {"load": 0.0, "submit": 0.0, "finalize": 0.0}
    results_iter = []
    t0 = time.time()
    if batch_size > 1 or mesh is not None:
        # keyed by its call parameters: a reused dict must not serve another
        # batch size or mesh
        bkey = ("batched", batch_size) + (() if mesh is None else (tuple(mesh.shape.items()),))
        if bkey not in engines:
            engines[bkey] = BatchedInferenceEngine(cfg, test_cfg, params, batch_size, mesh,
                                                   device)
        batched = engines[bkey]
        # 2-deep pipeline: batch i is fetched and pasted on the host after
        # batches i+1 and i+2 were submitted
        pending = deque()  # of (group, device outputs, rows to emit)

        def _drain_one():
            group, out, emit = pending.popleft()
            ts = time.time()
            res = batched.finalize_batch(out, [g[1] for g in group[:emit]])
            phase_s["finalize"] += time.time() - ts
            results_iter.extend((g[0], r) for g, r in zip(group, res))
            if verbose and len(results_iter) % (batch_size * 8) < batch_size:
                rate = len(results_iter) / (time.time() - t0)
                ph = " ".join(f"{k}={v:.1f}s" for k, v in phase_s.items())
                print(f"  {len(results_iter)}/{len(roidb)} ({rate:.2f} img/s, "
                      f"{batched.rerun_count} exact reruns; {ph})", flush=True)

        def _flush(group, emit):
            ts = time.time()
            out = batched.submit_batch([g[1] for g in group])
            phase_s["submit"] += time.time() - ts
            pending.append((group, out, emit))
            if len(pending) > 2:
                _drain_one()

        # every rank plans the same batches from the images' sizes (images
        # join their key's bucket in order, a full bucket is a batch) and
        # runs its data rows of each; a rank without any runs the batch's
        # last image and emits nothing (model peers must run every batch
        # together). Without a mesh, this process is the one rank.
        on = mesh or par.Mesh(1, 1, device)
        groups = plan_batches([batched.key_of_dims(e.height, e.width) for e in roidb],
                              batch_size)
        local, ranks, me = batched.batch_size, on.shape["data"], on.coords["data"]

        def rows(g, r):
            return g[r * local:(r + 1) * local]

        mine = [rows(g, me) or g[-1:] for g in groups]
        loader = iter(PrefetchLoader([roidb[i] for m in mine for i in m], make_sample,
                                     num_workers=4, prefetch=16))
        for g, m in zip(groups, mine):
            t_load = time.time()
            group = [next(loader) for _ in m]
            phase_s["load"] += time.time() - t_load
            for entry, args, _, _ in group:
                if batched.sample_key(args) != batched.key_of_dims(entry.height, entry.width):
                    raise ValueError(f"image {entry.file_path} is not the "
                                     f"{entry.height}x{entry.width} of its roidb entry")
            _flush([(e, (a, oh, ow)) for e, a, oh, ow in group], len(rows(g, me)))
        while pending:
            _drain_one()
        # every data rank's results (one model rank of each), in the plan's
        # order: batch by batch, data rank by data rank
        parts = par.all_gather_objects([r for _, r in results_iter], on)
        parts = [iter(parts[r * on.shape["model"]]) for r in range(ranks)]
        results_iter = [(roidb[i], next(parts[r])) for g in groups
                        for r in range(ranks) for i in rows(g, r)]
    elif multiscale:
        sizes = [int(s) for s in target_sizes]
        for entry, im, proposals in PrefetchLoader(roidb, make_sample, num_workers=4,
                                                   prefetch=16):
            results_iter.append((entry, engine.run_image_multiscale(im, sizes, proposals)))
    else:
        pending = None  # (entry, device outputs, args, oh, ow): 1-deep pipeline
        t_load = time.time()
        for entry, args, oh, ow in PrefetchLoader(roidb, make_sample, num_workers=4,
                                                  prefetch=16):
            ts = time.time()
            phase_s["load"] += ts - t_load
            out = engine.submit(args)
            phase_s["submit"] += time.time() - ts
            if pending is not None:
                ts = time.time()
                results_iter.append((pending[0], engine.finalize(*pending[1:])))
                phase_s["finalize"] += time.time() - ts
            pending = (entry, out, args, oh, ow)
            t_load = time.time()
        if pending is not None:
            ts = time.time()
            results_iter.append((pending[0], engine.finalize(*pending[1:])))
            phase_s["finalize"] += time.time() - ts

    bbox_results, segm_results_all, kps_results = [], [], []
    for i, (entry, res) in enumerate(results_iter):
        bbox_results.extend(detections_to_coco_bbox(
            res["boxes"], res["scores"], res["classes"], entry.image_id,
            dataset.contiguous_to_json))
        if "rles" in res:
            for rle, score, cls in zip(res["rles"], res["scores"], res["classes"]):
                segm_results_all.append({
                    "image_id": int(entry.image_id),
                    "category_id": int(dataset.contiguous_to_json[int(cls)]),
                    "segmentation": rle,
                    "score": float(score),
                })
        if "keypoints" in res:
            kps_results.extend(detections_to_coco_keypoints(
                res["keypoints"], res["scores"], res["classes"], entry.image_id,
                dataset.contiguous_to_json, confidence=test_cfg.keypoint_confidence))
        if verbose and (i + 1) % 100 == 0:
            rate = (i + 1) / (time.time() - t0)
            print(f"  {i+1}/{len(roidb)} ({rate:.2f} img/s)", flush=True)

    infer_seconds = time.time() - t0  # loading + device + paste + RLE + gather + collect
    if verbose:
        print("  time split: " + " ".join(f"{k}={v:.2f}s" for k, v in phase_s.items()),
              flush=True)

    def _eval(results, iou_type):
        if not results:
            return None
        if output_dir is not None:
            from detectorch_tpu_torch.eval import results_io

            ev = results_io.evaluate_from_results(
                dataset.coco, results, iou_type, output_dir,
                dataset_name=dataset_name, verbose=verbose)
            return ev.stats
        ev = COCOeval(dataset.coco, dataset.coco.load_res(results), iou_type)
        ev.evaluate()
        ev.accumulate()
        if per_class_ap:
            from detectorch_tpu_torch.eval import results_io

            results_io.log_per_class_ap(ev, verbose=verbose)
        return ev.summarize(verbose=verbose)

    bbox_stats = _eval(bbox_results, "bbox")
    segm_stats = _eval(segm_results_all, "segm") if cfg.use_mask else None
    kps_stats = _eval(kps_results, "keypoints") if cfg.keypoint is not None else None
    return bbox_stats, segm_stats, {
        "bbox": bbox_results, "segm": segm_results_all,
        "keypoints": kps_results, "keypoints_stats": kps_stats,
        "images_per_sec": len(roidb) / infer_seconds,
        "phase_seconds": phase_s,
    }
