"""The port's traffic laboratory (``rlo_tpu_torch/workloads``) against the
JAX package's (``rlo_tpu/workloads``) on the CPU: every trace kind at
three seeds gives the same digest and the same JSONL bytes, reads back
the same, and feeds the serving and fabric adapters the same rows; every
weather profile draws the same delay and drop sequence from the same
``random.Random`` and scripts the same churn. All exact."""

import random

import pytest

from rlo_tpu import workloads as ref
from rlo_tpu.workloads import traces as ref_traces
from rlo_tpu.workloads import weather as ref_weather
from rlo_tpu_torch import workloads as port
from rlo_tpu_torch.workloads import traces as port_traces
from rlo_tpu_torch.workloads import weather as port_weather

SEEDS = (0, 1, 2)


def test_export_surface_equals_reference():
    assert port.__all__ == ref.__all__
    assert port.TRACE_KINDS == ref.TRACE_KINDS
    assert port.WEATHER_KINDS == ref.WEATHER_KINDS
    assert port.TRACE_SCHEMA == ref.TRACE_SCHEMA


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ref.TRACE_KINDS)
def test_trace_bytes_equal_reference(kind, seed, tmp_path):
    want = ref.make_trace(kind, seed)
    got = port.make_trace(kind, seed)
    assert got.digest() == want.digest()
    assert got.dumps() == want.dumps()
    want.dump_jsonl(tmp_path / "ref.jsonl")
    got.dump_jsonl(tmp_path / "port.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    back = port.Trace.load_jsonl(tmp_path / "ref.jsonl")
    assert back.digest() == want.digest() and back.dumps() == want.dumps()
    assert got.serve_requests() == want.serve_requests()
    assert got.fabric_arrivals((1, 2, 3), time_scale=0.5) == \
        want.fabric_arrivals((1, 2, 3), time_scale=0.5)
    rows = [r.row() for r in want.requests]
    assert port.trace_digest(rows) == ref.trace_digest(rows)


@pytest.mark.parametrize("kind", ref.TRACE_KINDS)
def test_trace_overrides_equal_reference(kind):
    want = ref.make_trace(kind, 5, horizon=60.0, vocab=512)
    got = port.make_trace(kind, 5, horizon=60.0, vocab=512)
    assert got.dumps() == want.dumps()


@pytest.mark.parametrize("text", ["", "not json\n", '{"schema": 99}\n',
                                  '[1, 2]\n'])
def test_trace_rejects_as_reference(text):
    with pytest.raises(ref.TraceError) as want:
        ref.Trace.loads(text)
    with pytest.raises(port.TraceError) as got:
        port.Trace.loads(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_compat_equals_reference(seed):
    kw = dict(n_req=40, rate=2.0, seed=seed, max_len=256,
              buckets=(32, 64, 128), prefix_len=16)
    want = ref.poisson_compat(1000, **kw)
    got = port.poisson_compat(1000, **kw)
    assert [(list(map(int, p)), int(m)) for p, m in got[0]] == \
        [(list(map(int, p)), int(m)) for p, m in want[0]]
    assert list(got[1]) == list(want[1])
    assert port.compat_digest(*got) == ref.compat_digest(*want)


def _draws(weather, seed, n=400):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        out.append(None if weather.delay_fn is None
                   else weather.delay_fn(rng))
        out.append(None if weather.drop_fn is None
                   else weather.drop_fn(rng))
    return out


PROFILES = [
    ("wan", {}), ("wan", dict(alpha=1.5, scale=0.02)),
    ("burst_loss", {}), ("burst_loss", dict(p_enter=0.1, p_exit=0.3)),
    ("churn", dict(world_size=8, rate=0.1, duration=120.0)),
    ("churn", dict(world_size=16, rate=0.05, duration=60.0, start=8.0,
                   mean_down=20.0, min_down=13.0, min_live=14,
                   settle=25.0, immortal=(0,),
                   gilbert=dict(p_enter=0.05, p_exit=0.4))),
    ("storm", {}),
]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,kw", PROFILES,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(PROFILES)])
def test_weather_draws_equal_reference(name, kw, seed):
    want = ref.make_weather(name, seed, **dict(kw))
    got = port.make_weather(name, seed, **dict(kw))
    assert repr(got) == repr(want)
    assert got.script == want.script
    assert _draws(got, seed) == _draws(want, seed)


def test_weather_rejects_as_reference():
    for name, kw in (("fog", {}), ("churn", {})):
        with pytest.raises(ValueError) as want:
            ref.make_weather(name, 0, **kw)
        with pytest.raises(ValueError) as got:
            port.make_weather(name, 0, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", SEEDS)
def test_churn_script_equals_reference(seed):
    kw = dict(world_size=12, rate=0.2, duration=200.0, max_kills=9,
              immortal=(0, 5))
    assert port_weather.churn_script(seed, **kw) == \
        ref_weather.churn_script(seed, **kw)


def test_samplers_equal_reference():
    for seed in SEEDS:
        r1, r2 = random.Random(seed), random.Random(seed)
        d1, d2 = port_weather.HeavyTailDelay(), ref_weather.HeavyTailDelay()
        g1, g2 = port_weather.GilbertLoss(), ref_weather.GilbertLoss()
        assert [(d1(r1), g1(r1)) for _ in range(300)] == \
            [(d2(r2), g2(r2)) for _ in range(300)]
        g1.reset()
        g2.reset()
        assert repr(g1) == repr(g2)
    assert port_traces.TRACE_KINDS == ref_traces.TRACE_KINDS
