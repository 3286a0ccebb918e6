"""Condition types of the control experts.

The extractors themselves (``ctrl_adapter_tpu/conditions/``) are not ported
yet; this holds the expert order of the released multi-condition checkpoints,
copied from ``ctrl_adapter_tpu/conditions/extractors.py``.
"""

# reference expert order for multi-condition checkpoints (`inference.py:314-345`)
MULTI_CONDITION_EXPERT_ORDER = (
    "depth", "canny", "normal", "softedge", "segmentation", "lineart", "openpose",
)
