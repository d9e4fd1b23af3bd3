"""The int8 lane over the other 22 of the 44 registry names (sorted): each
int8 engine's folded tree holds every weight as int8, no float weight
(``tests/_torch_int8.py``)."""

import pytest

from _torch_int8 import NAMES, check_folded_tree_holds_no_float_weight
from _torch_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("name", NAMES[22:])
def test_int8_folded_tree_holds_no_float_weight(name):
    check_folded_tree_holds_no_float_weight(name)
