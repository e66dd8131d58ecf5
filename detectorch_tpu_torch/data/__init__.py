"""Input data: the COCO dataset and roidb, image transforms, the prefetch
loader (host, numpy) and on-device preprocessing."""
