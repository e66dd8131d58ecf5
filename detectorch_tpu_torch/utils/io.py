"""Object serialisation helpers (reference lib/utils/io.py:21-25).

The port's own copy of ``save_object`` and ``load_object`` from
``detectorch_tpu/utils/io.py``, held to them by tests/test_torch_utils.py.
That module's ``enable_persistent_compile_cache`` turns on XLA's persistent
compilation cache and has no counterpart here: the port runs eagerly and
compiles no program.
"""

from __future__ import annotations

import os
import pickle


def save_object(obj, file_name: str):
    """Pickle-dump obj (protocol 2, matching Detectron outputs)."""
    file_name = os.path.abspath(file_name)
    os.makedirs(os.path.dirname(file_name), exist_ok=True)
    with open(file_name, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)


def load_object(file_name: str):
    with open(file_name, "rb") as f:
        return pickle.load(f, encoding="latin1")

