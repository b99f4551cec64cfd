"""The port's grouped-agg dispatch policy against the JAX package's.

Each case asks both policies the same question: the same key domain,
dtypes, aggregate set and knobs, on the platform that corresponds (the
JAX package's ``tpu`` is the port's ``cuda``; its ``pallas`` backend
value is the port's ``cuda``). The reason strings must be identical; the
kernels differ only by name, and by the port's ``auto`` on the CPU,
which picks the CUDA kernel's plain version where the reference picks
its one-hot matmul.
"""

import pytest

from auron_tpu import config as jcfg
from auron_tpu.columnar.schema import DataType as JDT
from auron_tpu.kernels import dispatch as jdispatch
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.kernels import dispatch as tdispatch
from auron_tpu_torch.kernels import registry

_PLATFORM = {"cpu": "cpu", "tpu": "cuda"}
_BACKEND = {"auto": "auto", "pallas": "cuda", "dense": "dense",
            "sort": "sort"}

# (id, overrides of the question, knob values)
CASES = [
    ("eligible", {}, {}),
    ("unbounded", {"key_domain": None}, {}),
    ("empty_domain", {"key_domain": 0}, {}),
    ("negative_domain", {"key_domain": -3}, {}),
    ("above_hard_cap", {"key_domain": (1 << 16) + 1}, {}),
    ("above_config_cap", {"key_domain": 1 << 12},
     {"auron.kernels.max_key_domain": 1 << 10}),
    ("full_domain", {"key_domain": 1 << 16}, {}),
    ("disabled", {}, {"auron.kernels.enabled": False}),
    ("multi_key", {"key_dtypes": ("INT64", "INT32")}, {}),
    ("no_key", {"key_dtypes": ()}, {}),
    ("string_key", {"key_dtypes": ("STRING",)}, {}),
    ("float_key", {"key_dtypes": ("FLOAT64",)}, {}),
    ("int8_key", {"key_dtypes": ("INT8",)}, {}),
    ("collect_list", {"agg_fns": ("sum", "collect_list")}, {}),
    ("count_star", {"agg_fns": ("count_star",)}, {}),
    ("string_value", {"agg_fns": ("min",), "value_dtypes": ("STRING",)}, {}),
    ("decimal_value", {"value_dtypes": ("DECIMAL",)}, {}),
    ("date_value", {"value_dtypes": ("DATE32",)}, {}),
    ("backend_sort", {}, {"auron.kernels.backend": "sort"}),
    ("backend_dense", {}, {"auron.kernels.backend": "dense"}),
    ("backend_pallas", {}, {"auron.kernels.backend": "pallas"}),
]


def _question(dt, overrides):
    q = {"key_domain": 1 << 12, "key_dtypes": ("INT64",),
         "agg_fns": ("sum", "count", "avg"), "value_dtypes": ("FLOAT64",)}
    q.update(overrides)
    q["key_dtypes"] = tuple(dt[n] for n in q["key_dtypes"])
    q["value_dtypes"] = tuple(dt[n] for n in q["value_dtypes"])
    return q


def _decide(case, platform):
    _, overrides, knobs = case
    jconf = jcfg.AuronConfig(knobs)
    tknobs = dict(knobs)
    if "auron.kernels.backend" in knobs:
        tknobs["auron.kernels.backend"] = _BACKEND[knobs[
            "auron.kernels.backend"]]
    tconf = tcfg.AuronConfig(tknobs)
    want = jdispatch.select_grouped_agg(
        **_question(JDT, overrides), conf=jconf, platform=platform,
        record=False)
    got = tdispatch.select_grouped_agg(
        **_question(TDT, overrides), conf=tconf,
        platform=_PLATFORM[platform], record=False)
    return want, got


def _expected_port_kernel(want, platform):
    if want.kernel == "sort":
        return "sort", False
    if want.kernel == "pallas_vmem":
        return "cuda_dense", platform != "tpu"
    if want.kernel == "dense_matmul" and want.reason == "eligible":
        # the reference's auto picks the matmul off the TPU; the port's
        # picks the CUDA kernel (natively on cuda, else its plain version)
        return None
    return want.kernel, want.interpret


@pytest.mark.parametrize("platform", ["cpu", "tpu"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reason_matches_reference(case, platform):
    want, got = _decide(case, platform)
    assert got.reason == want.reason
    assert got.is_dense == want.is_dense
    expected = _expected_port_kernel(want, platform)
    knob = case[2].get("auron.kernels.backend", "auto")
    if expected is None:
        expected = ("dense_matmul", False) if knob == "dense" else \
            ("cuda_dense", _PLATFORM[platform] != "cuda")
    assert (got.kernel, got.interpret) == expected
    assert got.bytes_per_row == tdispatch.BYTES_PER_ROW[got.kernel]


@pytest.mark.parametrize("choice,platform,expected", [
    ("auto", "cuda", ("cuda_dense", False)),
    ("auto", "cpu", ("cuda_dense", True)),
    ("cuda", "cuda", ("cuda_dense", False)),
    ("cuda", "cpu", ("cuda_dense", True)),
    ("dense", "cuda", ("dense_matmul", False)),
    ("sort", "cpu", ("sort", False)),
])
def test_backend_for_platform(choice, platform, expected):
    conf = tcfg.AuronConfig({tcfg.KERNELS_BACKEND: choice})
    assert tdispatch.backend_for_platform(conf, platform) == expected


def test_unknown_backend_raises():
    conf = tcfg.AuronConfig({tcfg.KERNELS_BACKEND: "pallas"})
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        tdispatch.backend_for_platform(conf, "cuda")


def test_config_env_binding_and_types(monkeypatch):
    monkeypatch.setenv("AURON_CONF_KERNELS_ENABLED", "off")
    conf = tcfg.AuronConfig()
    assert conf.get(tcfg.KERNELS_ENABLED) is False
    conf.set(tcfg.KERNELS_ENABLED, "yes")
    assert conf.get(tcfg.KERNELS_ENABLED) is True
    conf.unset(tcfg.KERNELS_ENABLED)
    assert conf.get(tcfg.KERNELS_ENABLED) is False
    with pytest.raises(TypeError):
        conf.set(tcfg.KERNELS_MAX_KEY_DOMAIN, 1.5)
    with pytest.raises(KeyError):
        conf.set("auron.mesh.enabled", True)
    conf.set(tcfg.HASHTABLE_LOAD_FACTOR, 1)
    assert conf.get(tcfg.HASHTABLE_LOAD_FACTOR) == 1.0
    # the port's knobs keep the reference's names, types and defaults
    ref = {o.key: (o.dtype, o.default) for o in jcfg.options()}
    for opt in tcfg.options():
        assert ref[opt.key] == (opt.dtype, opt.default)


def test_decisions_are_counted():
    before = registry.snapshot()
    tdispatch.select_grouped_agg(
        key_domain=100, key_dtypes=(TDT.INT32,), agg_fns=("sum",),
        value_dtypes=(TDT.FLOAT32,), conf=tcfg.AuronConfig(),
        platform="cpu")
    d = tdispatch.select_grouped_agg(
        key_domain=None, key_dtypes=(TDT.INT32,), agg_fns=("sum",),
        value_dtypes=(TDT.FLOAT32,), conf=tcfg.AuronConfig(),
        platform="cpu")
    tdispatch.record_rows(d, 1000)
    after = registry.snapshot()
    assert after["cuda_dense"]["selected"] == \
        before["cuda_dense"]["selected"] + 1
    assert after["cuda_dense"]["interpret"] == \
        before["cuda_dense"]["interpret"] + 1
    assert after["sort"]["fallback"] == before["sort"]["fallback"] + 1
    assert after["sort"]["bytes_moved_est"] == \
        before["sort"]["bytes_moved_est"] + 1000 * 48
    assert {k.name for k in registry.kernels()} == \
        {"cuda_dense", "dense_matmul", "hashtable", "sort"}
    assert registry.lookup("cuda_dense").platforms == ("cuda",)


# ---------------------------------------------------------------------------
# the general path: hashtable vs sort (select_hash_agg)
# ---------------------------------------------------------------------------

# (id, overrides of the question, knob values): the reference's
# tests/test_hashtable.py::TestDispatchPolicy cases and their neighbours
HASH_CASES = [
    ("eligible", {}, {}),
    ("disabled", {}, {"auron.hashtable.enabled": False}),
    ("backend_sort", {}, {"auron.hashtable.backend": "sort"}),
    ("backend_hash", {}, {"auron.hashtable.backend": "hash"}),
    ("no_keys", {"key_dtypes": ()}, {}),
    ("nested_keys", {"key_dtypes": ("STRUCT",)}, {}),
    ("list_after_int", {"key_dtypes": ("INT64", "LIST")}, {}),
    ("string_and_decimal_keys", {"key_dtypes": ("STRING", "DECIMAL")}, {}),
    ("float_and_date_keys", {"key_dtypes": ("FLOAT64", "DATE32")}, {}),
    ("collect_kind", {"acc_kinds": ("collect_set",)}, {}),
    ("count_and_first", {"acc_kinds": ("sum", "first", "min", "max")},
     {}),
    ("float_sum_auto", {"has_float_sum": True}, {}),
    ("float_sum_forced", {"has_float_sum": True},
     {"auron.hashtable.backend": "hash"}),
    ("float_sum_sort", {"has_float_sum": True},
     {"auron.hashtable.backend": "sort"}),
    ("knobs_ride", {}, {"auron.hashtable.load_factor": 0.25,
                        "auron.hashtable.max_probe_rounds": 17}),
    ("zero_rounds_clamped", {}, {"auron.hashtable.max_probe_rounds": 0}),
]


def _hash_question(dt, overrides):
    q = {"key_dtypes": ("INT64",), "acc_kinds": ("sum", "or"),
         "has_float_sum": False}
    q.update(overrides)
    q["key_dtypes"] = tuple(dt[n] for n in q["key_dtypes"])
    return q


@pytest.mark.parametrize("case", HASH_CASES, ids=[c[0] for c in HASH_CASES])
def test_hash_agg_decision_matches_reference(case):
    _, overrides, knobs = case
    want = jdispatch.select_hash_agg(
        **_hash_question(JDT, overrides), conf=jcfg.AuronConfig(knobs),
        record=False)
    got = tdispatch.select_hash_agg(
        **_hash_question(TDT, overrides), conf=tcfg.AuronConfig(knobs),
        record=False)
    assert (got.backend, got.reason, got.is_hash) == \
        (want.backend, want.reason, want.is_hash)
    assert (got.load_factor, got.max_probe_rounds) == \
        (want.load_factor, want.max_probe_rounds)


def test_hash_agg_unknown_backend_raises_in_both():
    q = {"key_dtypes": (), "acc_kinds": (), "has_float_sum": False}
    for disp, conf in ((jdispatch, jcfg), (tdispatch, tcfg)):
        c = conf.AuronConfig({"auron.hashtable.backend": "radix"})
        with pytest.raises(ValueError, match="unknown backend 'radix'"):
            disp.select_hash_agg(conf=c, **q)


class _Metrics:
    """The operator-metrics shape select_hash_agg writes to."""

    class _Counter:
        def __init__(self):
            self.value = 0

        def add(self, v):
            self.value += v

    def __init__(self):
        self.counters = {}

    def counter(self, name):
        return self.counters.setdefault(name, self._Counter())


def test_hash_agg_decisions_are_counted():
    before = registry.snapshot()["hashtable"]
    m = _Metrics()
    q = {"key_dtypes": (TDT.INT64,), "acc_kinds": ("sum",)}
    conf = tcfg.AuronConfig()
    assert tdispatch.select_hash_agg(has_float_sum=False, conf=conf,
                                     metrics=m, **q).is_hash
    assert not tdispatch.select_hash_agg(has_float_sum=True, conf=conf,
                                         metrics=m, **q).is_hash
    tdispatch.select_hash_agg(has_float_sum=True, conf=conf, record=False,
                              metrics=m, **q)
    tdispatch.record_operator_choice(m, "hashtable")
    after = registry.snapshot()["hashtable"]
    assert after["selected"] == before["selected"] + 1
    assert after["fallback"] == before["fallback"] + 1
    assert {k: c.value for k, c in m.counters.items()} == {
        "hashtable_selected": 1, "hashtable_fallback": 1,
        "dispatch_hashtable": 1}
