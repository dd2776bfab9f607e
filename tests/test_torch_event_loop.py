"""The port's async expert tier and event timeline against the JAX
package's (host code on both sides: no model, no device).

The same seeded programs — lane and aggregate dispatch, stragglers, server
failure with re-dispatch, recovery, migration occupancy, elastic resize,
client cancellation, completion — drive ``repro.serving``'s
``AsyncExpertTier`` / ``EventTimeline`` and ``repro_torch.serving``'s.
Every micro-batch's placement and start / finish times, the conservation
counters, the live queue signals and the fired-event log fingerprint must
be equal (exact floats: the port keeps the reference's float64 host
arithmetic).  The fixed seeds cover every path; the hypothesis sweeps
widen them.
"""

import numpy as np
import pytest

from repro.serving import AsyncExpertTier as JTier
from repro.serving import EventTimeline as JTimeline
from repro_torch.serving import AsyncExpertTier as TTier
from repro_torch.serving import EventTimeline as TTimeline
from repro_torch.serving.event_loop import AGGREGATE_LANE


def _mbs(mbs):
    return [(m.mb_id, m.client_id, m.wave_id, m.server, m.expert, m.tokens,
             m.work, m.enqueue_t, m.start_t, m.finish_t, m.generation,
             m.done, m.cancelled) for m in mbs]


def _state(tier):
    lanes = [(ln.server, ln.expert, ln.busy_until, ln.enqueued, ln.drained,
              ln.cancelled, ln.moved) for ln in tier.lanes()]
    queues = [(q.rank, q.alive, q.slowdown, list(q.streams), q.enqueued,
               q.drained, q.cancelled, q.moved) for q in tier.queues]
    return (tier.enqueued, tier.completed, tier.cancelled, tier.redispatched,
            tier.migration_busy, tier.in_flight(), sorted(tier.mbs), lanes,
            queues)


def _play(Tier, Timeline, seed: int, servers: int, budget: int,
          queue_mode: str, waves: int):
    """One seeded program against one implementation: returns the trace of
    every call's result, the final state and the timeline fingerprint."""
    rng = np.random.default_rng(seed)
    tier = Tier(servers, queue_mode=queue_mode, lane_budget=budget)
    tl = Timeline()
    events, out, now = {}, [], 0.0
    for w in range(waves):
        now += float(rng.uniform(0.0, 2e-3))
        n = tier.num_servers
        client = int(rng.integers(3))
        if queue_mode == "server" or rng.random() < 0.3:
            work = rng.uniform(0.0, 1e-3, n) * (rng.random(n) < 0.8)
            mbs = tier.dispatch(client, w, work, now,
                                tokens=rng.uniform(0.0, 8.0, n))
        else:
            entries = [(int(rng.integers(n)), int(rng.integers(-1, 5)),
                        float(rng.uniform(-1e-4, 1e-3)),
                        float(rng.uniform(0.0, 8.0)))
                       for _ in range(int(rng.integers(0, 2 * n + 1)))]
            mbs = tier.dispatch_lanes(client, w, entries, now)
        for mb in mbs:
            events[mb.mb_id] = tl.post(mb.finish_t, "mb_done", mb=mb.mb_id,
                                       gen=mb.generation, server=mb.server,
                                       expert=mb.expert, obj=mb)
        out.append(("dispatch", _mbs(mbs)))
        op = rng.random()
        rank = int(rng.integers(tier.num_servers))
        if op < 0.12:
            moved = tier.fail_server(rank, now)
            for mb in moved:
                stale = events.pop(mb.mb_id, None)
                if stale is not None:
                    tl.cancel(stale)
                events[mb.mb_id] = tl.post(mb.finish_t, "mb_done",
                                           mb=mb.mb_id, gen=mb.generation,
                                           server=mb.server)
            out.append(("fail", rank, _mbs(moved)))
        elif op < 0.24:
            tier.recover_server(rank, now)
        elif op < 0.34:
            tier.set_slowdown(rank, float(rng.uniform(0.25, 5.0)))
        elif op < 0.40:
            tier.occupy_all(now, float(rng.uniform(0.0, 1e-3)))
        elif op < 0.46:
            moved = tier.resize(int(rng.integers(1, servers + 2)), now)
            if rng.random() < 0.5:
                tier.reset_speeds()
            out.append(("resize", _mbs(moved)))
        elif op < 0.52:
            out.append(("cancel", tier.cancel_client(client)))
        elif op < 0.56:
            tl.clear_pending()
            events.clear()
        out.append(("signals", tier.queue_signals(now),
                    [tier.expert_in_flight(e) for e in range(-1, 5)]))
        # fire what is due by now, in (time, seq) order
        while tl.peek_time() is not None and tl.peek_time() <= now:
            ev = tl.pop()
            p = ev.payload
            if tier.is_current(p["mb"], p["gen"]):
                tier.mark_done(tier.mbs[p["mb"]])
        out.append(("state", _state(tier)))
    while tl.pop() is not None:
        pass
    return out, _state(tier), tl.fingerprint(), tl.fingerprint(ndigits=6)


def _assert_same(seed, servers, budget, queue_mode, waves):
    ref = _play(JTier, JTimeline, seed, servers, budget, queue_mode, waves)
    port = _play(TTier, TTimeline, seed, servers, budget, queue_mode, waves)
    for i, (a, b) in enumerate(zip(ref[0], port[0])):
        assert a == b, (i, a, b)
    assert len(ref[0]) == len(port[0])
    assert ref[1:] == port[1:]


@pytest.mark.parametrize("seed,servers,budget,queue_mode", [
    (0, 4, 1, "expert"), (1, 3, 2, "expert"), (2, 1, 1, "expert"),
    (3, 5, 3, "expert"), (4, 4, 1, "server"), (5, 2, 2, "server")])
def test_seeded_programs_match_reference(seed, servers, budget, queue_mode):
    _assert_same(seed, servers, budget, queue_mode, waves=40)


def test_tier_unit_paths_match_reference():
    """The reference's unit scenarios (tests/test_event_loop.py), each
    step's micro-batches and the tier state equal."""
    def play(Tier):
        out = []
        t = Tier(3, lane_budget=2)
        out.append(_mbs(t.dispatch_lanes(
            0, 0, [(0, 5, 10e-3), (2, 7, 2e-3), (1, 7, 1e-3)], now=0.0)))
        out.append(_mbs(t.fail_server(1, now=0.0)))
        t.recover_server(1, now=3.0)
        out.append(_mbs(t.dispatch(1, 1, [0.0, 1e-3, 0.0], now=3.0)))
        t.occupy_all(now=3.5, dt=0.5)
        out.append(_mbs(t.dispatch_lanes(2, 2, [(0, AGGREGATE_LANE, 1e-3)],
                                         now=3.5)))
        out.append(_mbs(t.resize(2, now=3.6)))
        out.append(_mbs(t.resize(4, now=3.7)))
        out.append(t.cancel_client(2))
        out.append(t.queue_signals(3.7))
        out.append(_state(t))
        return out
    assert play(JTier) == play(TTier)


def test_tier_validation_matches_reference():
    for kw in ({"queue_mode": "bogus"}, {"lane_budget": 0}):
        with pytest.raises(ValueError):
            JTier(2, **kw)
        with pytest.raises(ValueError):
            TTier(2, **kw)
    with pytest.raises(ValueError):
        TTier(2).set_slowdown(0, 0.0)


def test_timeline_ties_cancel_and_clear_match_reference():
    def play(Timeline):
        tl = Timeline()
        evs = [tl.post(t, f"k{i}", slot=i, req=object(), arr=np.zeros(2))
               for i, t in enumerate([0.3, 0.1, 0.1, 0.2, 0.1])]
        tl.cancel(evs[2])
        fired = [tl.pop().kind, tl.pop().kind]
        n_live = len(tl)
        tl.clear_pending()
        late = tl.post(0.05, "late", flag=True, x=1.5)
        fired.append(tl.pop().seq)
        return (fired, n_live, late.seq, tl.log, tl.fingerprint(),
                tl.peek_time(), tl.pop())
    assert play(JTimeline) == play(TTimeline)


try:
    import hypothesis
    from hypothesis import strategies as st
except ImportError:          # the fixed seeds above still cover every path
    hypothesis = None

if hypothesis is not None:
    @hypothesis.settings(max_examples=25, deadline=None)
    @hypothesis.given(seed=st.integers(0, 10_000),
                      servers=st.integers(1, 5), budget=st.integers(1, 3),
                      queue_mode=st.sampled_from(["expert", "server"]),
                      waves=st.integers(1, 25))
    def test_random_programs_match_reference(seed, servers, budget,
                                             queue_mode, waves):
        _assert_same(seed, servers, budget, queue_mode, waves)

    @hypothesis.settings(max_examples=25, deadline=None)
    @hypothesis.given(times=st.lists(st.floats(0.0, 100.0, allow_nan=False,
                                               width=32), min_size=1,
                                     max_size=40),
                      drop=st.sets(st.integers(0, 39)))
    def test_random_timelines_match_reference(times, drop):
        def play(Timeline):
            tl = Timeline()
            evs = [tl.post(t, "ev", idx=i) for i, t in enumerate(times)]
            for i in drop:
                if i < len(evs):
                    tl.cancel(evs[i])
            fired = []
            while tl.peek_time() is not None:
                ev = tl.pop()
                fired.append((ev.time, ev.seq, ev.payload["idx"]))
            return fired, tl.fingerprint()
        assert play(JTimeline) == play(TTimeline)
