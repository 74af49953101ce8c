"""The port's copy of the dynamic environments (``repro_torch.env``) against
the reference's ``repro.env``, on the CPU.

Every preset at seeds 0 and 1 realizes bitwise the reference's traces
(link rate, frequency cap, temperature, battery charge; for the chaos
presets the outage, corruption, preemption and dropout flags), its state
at every step and between steps is the reference's, and ``apply`` (the
``SystemParams`` view) and the quantized key the codesign cache and the
drift detector compare agree field for field.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import numpy as np
import pytest

from repro import env as jenv
from repro.core.cost_model import SystemParams as JSystemParams
from repro_torch import env as tenv
from repro_torch.core.cost_model import SystemParams

ENV_PRESETS = ("wifi_markov", "rayleigh_fading", "profile_replay",
               "battery_drain", "edge_day", "constant")
CHAOS_PRESETS = ("chaos_outage", "chaos_corruption", "chaos_preemption",
                 "chaos_storm", "chaos_clean")
BASE = dict(n_flop_agent=6.4e10, n_flop_server=1.92e11,
            emb_bytes_full=4.0e5, link_bps=1.0e6, tx_power_w=0.25)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ENV_PRESETS)
def test_env_preset_traces_bitwise(name, seed):
    want = getattr(jenv.presets, name)(seed=seed)
    got = getattr(tenv.presets, name)(seed=seed)
    assert (got.n_steps, got.dt_s, got.horizon_s) \
        == (want.n_steps, want.dt_s, want.horizon_s)
    for trace in ("link_trace", "f_cap_trace", "temp_trace", "soc_trace"):
        np.testing.assert_array_equal(getattr(got, trace),
                                      getattr(want, trace))
    assert got.is_constant() == want.is_constant()
    # every step and a point between steps and past the horizon
    times = [k * got.dt_s for k in range(got.n_steps)] \
        + [0.3 * got.dt_s, got.horizon_s * 2.0]
    base, jbase = SystemParams(**BASE), JSystemParams(**BASE)
    for t in times:
        s, js = got.state_at(t), want.state_at(t)
        assert dataclasses.astuple(s) == dataclasses.astuple(js)
        assert dataclasses.astuple(s.apply(base)) \
            == dataclasses.astuple(js.apply(jbase))
        assert s.quantize().key() == js.quantize().key()
        assert dataclasses.astuple(s.quantize()) \
            == dataclasses.astuple(js.quantize())
        assert s.key() == js.key()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CHAOS_PRESETS)
def test_chaos_preset_traces_bitwise(name, seed):
    kw = dict(n_agents=3) if name == "chaos_storm" else {}
    want = getattr(jenv.presets, name)(seed=seed, **kw)
    got = getattr(tenv.presets, name)(seed=seed, **kw)
    for trace in ("link_up", "corrupt", "server_up", "agents_up"):
        np.testing.assert_array_equal(getattr(got, trace),
                                      getattr(want, trace))
    assert [dataclasses.astuple(s) for s in got.states()] \
        == [dataclasses.astuple(s) for s in want.states()]
    assert got.is_clean() == want.is_clean()


@pytest.mark.parametrize("f_cap,link,soc", [
    (1.23e9, 3.3e6, 0.9), (0.6e9, 1.0e5, 0.1), (2.4e9, 0.0, 0.24)])
def test_quantized_key_and_apply_agree(f_cap, link, soc):
    """A state off every grid: the same buckets, the same view."""
    env_kw = dict(dt_s=1.0, horizon_s=4.0,
                  battery_reserve_soc=0.25, battery_min_scale=0.25)
    states = []
    for e in (tenv, jenv):
        env = e.Environment(
            **env_kw, link=e.TraceReplay(values=(link,), dwell_s=1.0),
            f_cap=e.TraceReplay(values=(f_cap,), dwell_s=1.0),
            battery=e.Battery(capacity_j=1e9, drain_w=0.0, soc0=soc))
        states.append(env.state_at(2.5))
    got, want = states
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.quantize().key() == want.quantize().key()
    assert dataclasses.astuple(got.apply(SystemParams(**BASE))) \
        == dataclasses.astuple(want.apply(JSystemParams(**BASE)))
