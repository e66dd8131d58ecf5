"""COCO results-file writing/loading + per-class AP logging.

Mirrors reference ``lib/utils/json_dataset_evaluator.py``:

  * ``_write_coco_bbox_results_file`` (:149-190), segms (:67-113) and
    keypoints (:349-416): the reference converts per-class/per-image
    accumulators into flat COCO-format dicts and json-dumps them; here the
    inference engine already emits those flat dicts, so the writer
    serialises them directly — same schema
    (``{image_id, category_id, bbox|segmentation|keypoints, score}``), same
    file naming (``<kind>_<dataset-name>_results[_<uuid>].json``);
  * ``_do_detection_eval`` / ``_do_segmentation_eval`` / ``_do_keypoint_eval``
    (:116-125, :193-202, :419-432): evaluation loads detections back FROM
    the written file (a real json round-trip, like the reference), runs
    COCOeval, and pickles the evaluator to ``<kind>_results.pkl``;
  * ``_log_detection_eval_metrics`` (:205-235): mean + per-category AP at
    IoU [0.5:0.95] table.

The port's own copy of ``detectorch_tpu/eval/results_io.py``, held to it by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

import json
import os
import pickle
import uuid
from typing import Dict, List, Optional

import numpy as np

from detectorch_tpu_torch.eval.coco_eval import COCO, COCOeval

_FILE_PREFIX = {"bbox": "bbox", "segm": "segmentations", "keypoints": "keypoints"}
_PKL_NAME = {
    "bbox": "detection_results.pkl",
    "segm": "segmentation_results.pkl",
    "keypoints": "keypoint_results.pkl",
}


def results_file_path(
    output_dir: str, iou_type: str, dataset_name: str, use_salt: bool = True
) -> str:
    """reference json_dataset_evaluator.py:48-54,134-140: file is
    '<prefix>_<dataset>_results[_<uuid4>].json'."""
    name = f"{_FILE_PREFIX[iou_type]}_{dataset_name}_results"
    if use_salt:
        name += f"_{uuid.uuid4()}"
    return os.path.join(output_dir, name + ".json")


def write_results_file(results: List[dict], path: str) -> str:
    """json-dump COCO-format result dicts (reference :165-167,85-87)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f)
    return path


def load_results_file(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def log_per_class_ap(
    coco_eval: COCOeval, verbose: bool = True
) -> Dict[str, float]:
    """Mean and per-category AP @ IoU [0.50, 0.95] — the table the reference
    prints after every eval (json_dataset_evaluator.py:205-235).

    Returns {category name: AP} (plus '__mean__'), NaN-free: categories with
    no valid precision entries get -1 like pycocotools' convention.
    """
    assert coco_eval.eval is not None, "run accumulate() first"
    iou_thrs = coco_eval.iou_thrs
    ind_lo = int(np.where(np.isclose(iou_thrs, 0.5))[0][0])
    ind_hi = int(np.where(np.isclose(iou_thrs, 0.95))[0][0])
    max_det_ind = len(coco_eval.max_dets) - 1
    # precision dims: (iou, recall, cls, area rng, max dets); area 0 = all
    precision = coco_eval.eval["precision"][
        ind_lo:ind_hi + 1, :, :, 0, max_det_ind
    ]
    vals = precision[precision > -1]
    ap_default = float(np.mean(vals)) if vals.size else -1.0
    out = {"__mean__": ap_default}
    if verbose:
        print("~~~~ Mean and per-category AP @ IoU=[0.50,0.95] ~~~~")
        print(f"{100 * ap_default:.1f}")
    cats = coco_eval.coco_gt.cats
    for k, cat_id in enumerate(coco_eval.cat_ids):
        pc = precision[:, :, k]
        pv = pc[pc > -1]
        ap = float(np.mean(pv)) if pv.size else -1.0
        name = cats.get(cat_id, {}).get("name", str(cat_id))
        out[name] = ap
        if verbose:
            print(f"{100 * ap:.1f}")
    if verbose:
        print("~~~~ Summary metrics ~~~~")
    return out


def evaluate_from_results(
    coco_gt: COCO,
    results: List[dict],
    iou_type: str,
    output_dir: str,
    dataset_name: str = "dataset",
    use_salt: bool = True,
    cleanup: bool = False,
    verbose: bool = True,
) -> Optional[COCOeval]:
    """Write the results json, evaluate FROM the file, log per-class AP,
    pickle the evaluator — the full reference evaluate_boxes/masks/keypoints
    flow (json_dataset_evaluator.py:40-64,128-146,322-346)."""
    res_file = results_file_path(output_dir, iou_type, dataset_name, use_salt)
    write_results_file(results, res_file)
    if verbose:
        print(f"Wrote {iou_type} results json to: {os.path.abspath(res_file)}")
    coco_dt = coco_gt.load_res(res_file)  # round-trip through the file
    ev = COCOeval(coco_gt, coco_dt, iou_type)
    ev.evaluate()
    ev.accumulate()
    log_per_class_ap(ev, verbose=verbose)
    ev.summarize(verbose=verbose)
    eval_file = os.path.join(output_dir, _PKL_NAME[iou_type])
    with open(eval_file, "wb") as f:
        pickle.dump(ev, f)
    if verbose:
        print(f"Wrote json eval results to: {eval_file}")
    if cleanup:
        os.remove(res_file)
    return ev
