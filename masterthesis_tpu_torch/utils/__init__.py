"""Generic helpers: the reflection registry and the image and timing helpers.

The port of ``masterthesis_tpu/utils/__init__.py``. The attribute dict is the
one of ``masterthesis_tpu_torch.arguments``, re-exported here.
"""
from __future__ import annotations

from inspect import isclass

from masterthesis_tpu_torch.arguments import AttributeDict  # noqa: F401
from masterthesis_tpu_torch.utils.images import (  # noqa: F401
    make_grid,
    save_image,
    save_images,
    tensor_to_image,
)
from masterthesis_tpu_torch.utils.profiling import AverageMeter, TimerBlock  # noqa: F401


def get_modules(module, superclass=None, filter=None):
    """Names of the classes in ``module`` (of ``superclass``; containing ``filter``)."""
    if superclass:
        modules = [
            x
            for x in dir(module)
            if isclass(getattr(module, x)) and issubclass(getattr(module, x), superclass)
        ]
    else:
        modules = [x for x in dir(module) if isclass(getattr(module, x))]
    if filter:
        modules = [m for m in modules if filter in m]
    return modules


def module_to_dict(module, exclude=()):
    """Map class name -> class for every class in ``module``."""
    return dict(
        (x, getattr(module, x))
        for x in dir(module)
        if x not in exclude and isclass(getattr(module, x)) and getattr(module, x) not in exclude
    )
