"""Box arithmetic, anchors, FPN level routing, NMS and RoIAlign in PyTorch."""
