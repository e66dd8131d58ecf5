"""Mean ms of a request's stage 'mask': the mask RoIAlign and the mask
head. CUDA events between the port's stage functions, the host never
waiting between them (harness/program.staged_request)."""


def read(layer):
    return layer["stages_ms"].get("mask")
