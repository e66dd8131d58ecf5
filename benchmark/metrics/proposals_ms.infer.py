"""Mean ms of a request's stage 'proposals': the RPN head and the proposals
(decode, NMS, collect). CUDA events between the port's stage functions,
the host never waiting between them (harness/program.staged_request)."""


def read(layer):
    return layer["stages_ms"].get("proposals")
