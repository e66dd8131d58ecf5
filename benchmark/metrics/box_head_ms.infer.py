"""Mean ms of a request's stage 'box_head': the box RoIAlign, the box head
and its predictors. CUDA events between the port's stage functions, the
host never waiting between them (harness/program.staged_request)."""


def read(layer):
    return layer["stages_ms"].get("box_head")
