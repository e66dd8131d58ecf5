"""Debug-mode numerical checking.

The port's counterpart of ``detectorch_tpu/utils/debug.py``. There,
``checked`` wraps a function with ``jax.experimental.checkify`` and its
``float_checks``, so that a NaN produced inside the compiled program surfaces
as an error naming the primitive instead of propagating silently into
detections. Here ``fn`` runs eagerly under a ``torch.overrides``
``TorchFunctionMode`` that looks at every floating tensor each torch
function returns and raises ``ValueError`` naming the first function whose
output holds a NaN. As with ``float_checks``, Inf is not flagged: the
port's NMS and top-k fill with -inf on purpose.

Each check reads a flag back from the tensor's device (a synchronise per
operation on a card): debug use only. Results of ``torch.empty*`` and
``Tensor.new_empty`` are not checked, since their memory holds whatever was
there until a kernel writes it (the RoIAlign kernels' outputs are such
buffers, filled through ``ctypes``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

# allocations whose memory is uninitialised until written
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided", "empty_permuted",
                            "new_empty", "new_empty_strided"})


def _name(func) -> str:
    """``Tensor.log`` for a method, ``torch.log`` or ``torch.nn.functional.pad``
    for a function."""
    name = getattr(func, "__name__", None) or repr(func)
    if isinstance(getattr(func, "__objclass__", None), type):
        return f"Tensor.{name}"
    module = getattr(func, "__module__", None)
    return f"{module}.{name}" if module else name


def _floating_tensors(out):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _floating_tensors(o)


class _NaNChecks(TorchFunctionMode):
    """Raise ValueError when a torch function returns a floating tensor that
    holds a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") not in _UNINITIALISED:
            for t in _floating_tensors(out):
                if bool(torch.isnan(t).any()):
                    raise ValueError(f"nan generated by {_name(func)}")
        return out


def checked(fn):
    """Wrap `fn` so that a NaN produced by any torch operation inside it
    raises ValueError naming that operation (the counterpart of JAX's
    ``checkify.float_checks``). Returns wrapped(*args, **kwargs) -> output."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _NaNChecks():
            return fn(*args, **kwargs)

    return wrapped


def _flatten_with_path(tree, path=""):
    """(key path, leaf) pairs in jax.tree_util's order and keystr format:
    dict keys sorted, ``['k']`` for dict keys, ``[i]`` for list and tuple
    items, ``.name`` for named-tuple fields; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _flatten_with_path(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def assert_finite_tree(tree, name: str = "tree"):
    """Host-side finiteness assertion over nested dicts, lists and tuples of
    tensors and arrays (post-hoc debugging); the message names the leaf as
    ``jax.tree_util.keystr`` does, e.g. ``tree['b'][0]``."""
    for path, leaf in _flatten_with_path(tree):
        if not _finite(leaf):
            raise AssertionError(f"non-finite values in {name}{path}")
