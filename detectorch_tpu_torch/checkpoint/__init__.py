"""Parameters: the JAX-params bridge, caffe2 Detectron pkls, checkpoints."""
