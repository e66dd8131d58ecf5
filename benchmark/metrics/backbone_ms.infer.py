"""Mean ms of a request's stage 'backbone': the backbone (ResNet-50
conv1..res5 and the FPN neck, or C4's conv1..res4). CUDA events between
the port's stage functions, the host never waiting between them
(harness/program.staged_request)."""


def read(layer):
    return layer["stages_ms"].get("backbone")
