"""The port's date functions and casts against the JAX package's.

The cases of ``torch_function_cases.py`` (dates from year 2 to 9900,
timestamps before and after 1970, parseable and unparseable strings)
for every name the reference's ``exprs/fn_dates.py`` registers, and the
casts of the slice: string → bool, int8, int32, int64, float32,
float64, date and timestamp; bool, integer, float, date and timestamp →
string (Java's float formatting); date ↔ timestamp; float → integer
(null out of range); integer → date and timestamp. Validity, values and
result types equal over the live rows; no tolerance. An ANSI cast
raises on a bad string; the host casts make one packed readback per
call and leave the rows past the row count zero.
"""

import numpy as np
import pytest
import torch

from auron_tpu_torch.columnar.batch import batch_from_numpy
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.columnar.schema import Field as TField
from auron_tpu_torch.columnar.schema import Schema as TSchema
from auron_tpu_torch.exprs import eval as teval
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.exprs import host
from tests import torch_function_cases as cases
from tests.torch_function_cases import ROWS, c

CAST_NODES = sorted(n for n in cases.NODES if n.startswith("cast_"))


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


@pytest.mark.parametrize("name,i", cases.function_cases("fn_dates"))
def test_date_function_equals_reference(name, i, batches):
    cases.check_function(name, i, batches)


@pytest.mark.parametrize("name", CAST_NODES)
def test_cast_equals_reference(name, batches):
    cases.check_node(name, batches)


def test_ansi_cast_raises_on_a_bad_string(batches):
    _jb, _js, tb, ts = batches
    with pytest.raises(ValueError, match="CAST_INVALID_INPUT"):
        teval.evaluate(cases.build(("cast", c("s"), "INT32", False), tir,
                                   TDT), tb, ts)
    digits = batch_from_numpy([(np.array([[ord("7")] + [0] * 7] * 4,
                                         np.uint8),
                                np.ones(4, np.int32), np.ones(4, bool))],
                              4, "cpu")
    out = teval.evaluate(tir.Cast(tir.ColumnRef(0), TDT.INT32, safe=False),
                         digits, TSchema((TField("s", TDT.STRING),)))
    assert out.data.tolist() == [7] * 4


def test_host_functions_read_back_once_per_call(batches, monkeypatch):
    """A cast from a string reads the batch back in one packed copy
    (``host_copy``, counted in ``host_readback.syncs`` off the CPU) and
    uploads once; its rows past the row count stay zero."""
    _jb, _js, tb, ts = batches
    copies = []
    real = host.host_copy
    monkeypatch.setattr(host, "host_copy",
                        lambda t: copies.append(t.numel()) or real(t))
    got = teval.evaluate(cases.build(("cast", c("s"), "INT64"), tir, TDT),
                         tb, ts)
    assert len(copies) == 1
    assert not got.validity[ROWS:].any() and not got.data[ROWS:].any()
    # three host casts: three readbacks
    three = cases.build(("fn", "concat",
                         ("cast", ("cast", c("s"), "DATE32"), "STRING"),
                         ("cast", c("i32"), "STRING")), tir, TDT)
    teval.evaluate(three, tb, ts)
    assert len(copies) == 4
