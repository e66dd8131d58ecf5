"""Detection postprocessing, the inference engines and COCO evaluation."""
