"""Condition extraction (``extractors.py``) and its networks.

``MULTI_CONDITION_EXPERT_ORDER`` lives in ``extractors.py``, as in the JAX
package, and is re-exported here.
"""

from .extractors import MULTI_CONDITION_EXPERT_ORDER

__all__ = ["MULTI_CONDITION_EXPERT_ORDER"]
