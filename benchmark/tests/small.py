"""The cells at a size a CPU test run holds: 2 images a batch in a 320x448
bucket (short side 300, long at most 440), 300 proposals an image; full
widths, every other test count as the configuration states it."""

CELLS = ("fpn_mask.infer_b8", "c4_mask.infer_b8")
SEED = 3_000_000_017  # over 32 signed bits, as a run's seed may be


def shrink(cell, cfg, mix):
    mix.update(batch=2, pool_batches=2, bucket=[320, 448], target_size=300, max_size=440)
    cfg["test"]["rpn_post_nms_top_n"] = 300
