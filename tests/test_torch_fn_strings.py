"""The port's string functions and string nodes against the JAX
package's.

The cases of ``torch_function_cases.py`` (strings of widths 16 and 8
with nulls, empty strings, bytes above 0x7F, spaces and delimiters) for
every name the reference's ``exprs/fn_strings.py`` registers
(``concat_ws``, ``initcap``, ``substring_index`` and the rest), and the
nodes of the slice over strings and numbers: ``Negative`` (INT64_MIN
wraps), ``CaseWhen`` with string branches of different widths and
without ``else``, ``LIKE`` in its three pattern classes (an equality,
``a%`` / ``%a`` / ``%a%``, and the host regex, which also takes
``a%b`` chains; negated too), ``startswith`` / ``endswith`` / ``contains`` and
``split(...)[i]``. Validity, bytes, lengths and result types equal over
the live rows; no tolerance.
"""

import pytest
import torch

from tests import torch_function_cases as cases

STRING_NODES = sorted(n for n in cases.NODES if not n.startswith("cast_"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batches():
    return cases.batches()


@pytest.mark.parametrize("name,i", cases.function_cases("fn_strings"))
def test_string_function_equals_reference(name, i, batches):
    cases.check_function(name, i, batches)


@pytest.mark.parametrize("name", STRING_NODES)
def test_node_equals_reference(name, batches):
    cases.check_node(name, batches)
