"""Faults planted in the port's ResNeXt trunk: each returns the timed entry
with the trunk broken where the program computes it, for the length of
each call. ``FAULTS[name](fn, model_cfg, test_cfg)`` -> the broken entry."""

import torch.nn.functional as F

from detectorch_tpu_torch.models import resnet


def _stride_on_1x1(params, x, prefix, stride, has_proj, groups=1):
    """ResNet's rule in a ResNeXt block: the stride on branch2a."""
    shortcut = resnet.conv_bn(params, x, f"{prefix}_branch1", stride=stride) if has_proj else x
    out = F.relu(resnet.conv_bn(params, x, f"{prefix}_branch2a", stride=stride))
    out = resnet.conv(out, params[f"{prefix}_branch2b_w"], 1, 1, groups)
    out = F.relu(resnet.affine(out, params[f"{prefix}_branch2b_bn_s"],
                               params[f"{prefix}_branch2b_bn_b"]))
    return F.relu(resnet.conv_bn(params, out, f"{prefix}_branch2c") + shortcut)


def _groups_permuted(conv):
    """The conv with each group of a grouped conv reading the next group's
    input channels."""
    def permuted(x, w, stride=1, pad=0, groups=1):
        if groups > 1:
            n, c, h, wd = x.shape
            x = x.reshape(n, groups, c // groups, h, wd).roll(1, dims=1).reshape(n, c, h, wd)
        return conv(x, w, stride, pad, groups)
    return permuted


def _patched(name, make):
    """The entry with ``resnet.<name>`` replaced by ``make(original)`` while
    it runs."""
    def fault(fn, model_cfg, test_cfg):
        def broken(params, *rows):
            original = getattr(resnet, name)
            setattr(resnet, name, make(original))
            try:
                return fn(params, *rows)
            finally:
                setattr(resnet, name, original)
        return broken
    return fault


FAULTS = {"stride_on_1x1": _patched("bottleneck", lambda _: _stride_on_1x1),
          "groups_permuted": _patched("conv", _groups_permuted)}
