"""A CPU model of the single-pass decoupled look-back scan that the port's
CUDA kernels run (``specpride_tpu_torch/ops/csrc/seg_scan_core.cuh``),
held against ``seg_scan_plain`` and ``seg_mean_plain``.

The model keeps the kernel's protocol and its workspace layout, and runs
behind the wrappers' own host side: ``kernels._launch`` takes the
workspace and its base under the workspace lock and hands them to the
model in place of a kernel entry point (a ticket counter in record 0, then
per tile a 32-byte record: a status word ``(stamp << 2) | kind`` and
separate aggregate and inclusive slots):

* each block takes the next ticket; its tile is the ticket minus the base;
* it scans its tile, then publishes at once: the inclusive prefix when the
  tile holds a head, else its aggregate;
* unless its first element is a head, it looks back over a window of
  predecessors, waiting until every tile up to the nearest inclusive
  prefix has published this call's stamp, sums the aggregates before it,
  and repeats one window further back if there is none; a tile without a
  head then publishes its inclusive prefix;
* the carry is added to the leading run only.

Blocks advance in a seeded random interleaving, each step one of: start
the next ticket, or move a started block to its next publish or wait, so a
look-back sees only what its predecessors have published so far.  The
tiles are 8 elements and the window 3 or 32 (the kernel's), so the cases
cross many tiles and look back over several windows.  Sums are float32,
as on the card: rtol 1e-5 against the float64 plain versions, counts
exact."""

import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from specpride_tpu_torch.ops import kernels

TILE = 8
AGG, INCL = 1, 2
CPU = torch.device("cpu")
LIB = SimpleNamespace(tile=TILE, record_bytes=32)  # the library's constants


class Records:
    """numpy views of a ``kernels.Workspace`` buffer in the kernel's
    layout."""

    def __init__(self, ws: kernels.Workspace):
        rec = ws.buf.numpy().reshape(-1, 32)
        self.counter = rec[0, 0:8].view(np.uint64)
        self.status = rec[1:, 0:8].view(np.uint64)[:, 0]
        self.agg = rec[1:, 8:20].view(np.float32)
        self.incl = rec[1:, 20:32].view(np.float32)

    def publish(self, t, stamp, kind, v):
        (self.incl if kind == INCL else self.agg)[t, : v.size] = v
        self.status[t] = np.uint64((stamp << 2) | kind)

    def kind(self, q, base):
        """What tile q published in this call (0: nothing yet)."""
        st = int(self.status[q])
        return st & 3 if st >> 2 == base + q + 1 else 0


def _block(recs, x, heads, base, window, out):
    """One block's life as a generator: it yields wherever the card could
    run another block first (after taking its ticket, after each publish,
    at each window read)."""
    ticket = int(recs.counter[0])
    recs.counter[0] = np.uint64(ticket + 1)
    t = ticket - base
    yield
    nc, n = x.shape
    lo, hi = t * TILE, min((t + 1) * TILE, n)
    h = heads[lo:hi]
    local = np.zeros((nc, hi - lo), np.float32)
    run = np.zeros(nc, np.float32)
    for k in range(hi - lo):
        run = x[:, lo + k].copy() if h[k] else run + x[:, lo + k]
        local[:, k] = run
    has_head = bool(h.any())
    stamp = base + t + 1
    recs.publish(t, stamp, INCL if has_head else AGG, local[:, -1])
    yield
    carry = np.zeros(nc, np.float32)
    if not h[0]:  # tile 0 always begins with a head
        p = t - 1
        while True:
            lanes = range(p, p - window, -1)
            kinds = [recs.kind(q, base) if q >= 0 else INCL for q in lanes]
            stop = kinds.index(INCL) if INCL in kinds else window
            if 0 in kinds[: stop + 1]:
                yield  # a predecessor up to the stop has not published
                continue
            for lane, q in enumerate(lanes):
                if lane < stop:
                    carry += recs.agg[q, :nc]
                elif lane == stop and q >= 0:
                    carry += recs.incl[q, :nc]
            if stop < window:
                break
            p -= window
            yield
        if not has_head:
            recs.publish(t, stamp, INCL, carry + local[:, -1])
            yield
    lead = int(np.argmax(h)) if has_head else hi - lo
    local[:, :lead] += carry[:, None]
    out[:, lo:hi] = local


def run_blocks(recs, heads, x, base, rng, window, out):
    """The launch: blocks take tickets from ``base`` and advance in a
    seeded random interleaving until every tile is written to ``out``."""
    tiles = -(-x.shape[1] // TILE)
    assert int(recs.counter[0]) == base  # the host's base is the counter
    waiting = tiles
    running = []
    while waiting or running:
        k = int(rng.integers(len(running) + (1 if waiting else 0)))
        if k == len(running):
            running.append(_block(recs, x, heads, base, window, out))
            waiting -= 1
            k = len(running) - 1
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    assert int(recs.counter[0]) == base + tiles


def model_entry(heads, x, rng, window, out):
    """A stand-in for a kernel entry point, with its arguments: it runs the
    model on the workspace at ``ws`` from ``base``.  Like a ctypes call it
    first lets other threads run."""

    def entry(runs, in0, in1, in2, out0, out1, out2, n, channels, ws, base,
              device, stream):
        time.sleep(0.001)
        (found,) = [w for w in kernels.workspaces.values()
                    if w.buf.data_ptr() == ws]
        run_blocks(Records(found), heads, x, base, rng, window, out)
        return 0

    return entry


def model_scan(heads, x, rng, window=32):
    """Segmented inclusive scan of the rows of ``x`` (float32, (nc, n)) by
    the look-back protocol, launched through ``kernels._launch``."""
    heads = np.asarray(heads, bool).copy()
    heads[0] = True
    out = np.full(x.shape, np.nan, np.float32)
    channels = [torch.from_numpy(r) for r in x]
    kernels._launch("seg_scan", model_entry(heads, x, rng, window, out), LIB,
                    torch.from_numpy(heads), channels, channels, len(x))
    return out


def model_mean(keys, w, values, rng, window=32):
    heads = np.ones(keys.size, bool)
    heads[1:] = keys[1:] != keys[:-1]
    x = np.stack([w] + [v * w for v in values]).astype(np.float32)
    s = model_scan(heads, x, rng, window)
    return [s[0]] + [c / np.maximum(s[0], np.float32(1)) for c in s[1:]]


def _heads(case, n, rng):
    h = rng.uniform(0, 1, n) < 0.15
    if case == "all_heads":
        h[:] = True
    elif case == "single_run":  # no head but element 0
        h[:] = False
    elif case == "run_across_tiles":  # one run from inside tile 0 to the end
        h[3:] = False
    elif case == "tile_starts":  # a head on every tile's first element
        h[::TILE] = True
    return h


SIZES = [TILE - 1, TILE, TILE + 1, 13 * TILE + 5]
CASES = ["random", "all_heads", "single_run", "run_across_tiles",
         "tile_starts"]


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    """The wrappers' host side on the CPU: stream 0, no graph capture, an
    empty workspace registry and launch counts of the test's own."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches,
                                                           0))
    kernels.workspaces.clear()
    yield
    kernels.workspaces.clear()


@pytest.mark.parametrize("window", [3, 32])
@pytest.mark.parametrize("nc", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_model_scan_matches_plain(case, nc, window):
    for n in SIZES:
        rng = np.random.default_rng([CASES.index(case), nc, window, n])
        heads = _heads(case, n, rng)
        x = rng.uniform(10.0, 1e4, (nc, n)).astype(np.float32)
        got = model_scan(heads, x, rng, window)
        want = kernels.seg_scan_plain(
            torch.from_numpy(heads), *(torch.from_numpy(r) for r in x)
        )
        for g, e in zip(got, want):
            np.testing.assert_allclose(g, e.numpy(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("window", [3, 32])
@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("case", ["random", "masked_run_start",
                                  "single_run", "all_heads"])
def test_model_mean_matches_plain(case, nv, window):
    for n in SIZES:
        rng = np.random.default_rng([nv, window, n, len(case)])
        starts = _heads("random" if case == "masked_run_start" else case, n,
                        rng)
        starts[0] = True
        keys = (np.cumsum(starts) - 1).astype(np.int32)
        w = (rng.uniform(0, 1, n) > 0.2).astype(np.float32)
        if case == "masked_run_start":
            # a run masked from its start, and one masked only at its start
            w[keys == keys[n // 2]] = 0.0
            w[np.flatnonzero(starts)[-1]] = 0.0
        values = [rng.uniform(10.0, 1e4, n).astype(np.float32)
                  for _ in range(nv)]
        got = model_mean(keys, w, values, rng, window)
        want = kernels.seg_mean_plain(
            *(torch.from_numpy(a) for a in (keys, w, *values))
        )
        np.testing.assert_array_equal(got[0], want[0].numpy())
        for g, e in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, e.numpy(), rtol=1e-5, atol=0)
        if case == "masked_run_start":
            masked = keys == keys[n // 2]
            assert (got[0][masked] == 0).all() and (got[1][masked] == 0).all()


@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("case", ["random", "single_run", "all_heads",
                                  "tile_starts"])
def test_model_heads_matches_plain(case, nv):
    """``seg_mean_heads``' channels (a count of ones, then int8 codes or
    f32 m/z and bf16 intensity, upcast) through the protocol, launched
    under its own name."""
    for n in SIZES:
        rng = np.random.default_rng([nv, n, len(case), 7])
        heads = _heads(case, n, rng)
        heads[0] = True
        if nv == 1:
            values = [torch.from_numpy(
                rng.integers(-127, 128, n).astype(np.int8))]
        else:
            values = [torch.from_numpy(rng.uniform(100, 2e3, n)
                                       .astype(np.float32)),
                      torch.from_numpy(rng.uniform(10, 1e4, n)
                                       .astype(np.float32)).bfloat16()]
        x = np.stack([np.ones(n, np.float32)]
                     + [v.float().numpy() for v in values])
        s = np.full(x.shape, np.nan, np.float32)
        kernels._launch("seg_mean_heads", model_entry(heads, x, rng, 32, s),
                        LIB, torch.from_numpy(heads), values, values, nv)
        got = [s[0]] + [c / np.maximum(s[0], np.float32(1)) for c in s[1:]]
        want = kernels.seg_mean_heads_plain(torch.from_numpy(heads),
                                            *values)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        for g, e in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, e.numpy(), rtol=1e-5, atol=0)
    assert kernels.launches["seg_mean_heads"] == len(SIZES)
    assert kernels.launches["seg_scan"] == kernels.launches["seg_mean"] == 0


def test_records_of_earlier_calls_are_never_read():
    """Calls share one workspace without clearing it: records left by a
    larger earlier call carry older stamps and are waited on, not read."""
    rng = np.random.default_rng(5)
    for n in (40 * TILE, 3 * TILE + 1, 17 * TILE, 40 * TILE - 3, 1):
        heads = rng.uniform(0, 1, n) < 0.05
        x = rng.uniform(10.0, 1e4, (2, n)).astype(np.float32)
        got = model_scan(heads, x, rng, window=3)
        want = kernels.seg_scan_plain(torch.from_numpy(heads),
                                      *(torch.from_numpy(r) for r in x))
        for g, e in zip(got, want):
            np.testing.assert_allclose(g, e.numpy(), rtol=1e-5, atol=0)
    (ws,) = kernels.workspaces.values()
    assert ws.tiles == 40 and ws.base == 40 + 4 + 17 + 40 + 1


def test_stale_record_with_a_later_stamp_would_be_read():
    """The stamp is what guards a record: a forged status word carrying the
    stamp the next call expects is taken as published.  (The counter only
    grows, so no real record carries a stamp ahead of it.)"""
    ws = kernels.workspace(CPU, 0, 4, 32)
    recs = Records(ws)
    recs.publish(0, ws.base + 1, INCL, np.float32([5.0]))
    assert recs.kind(0, ws.base) == INCL
    assert recs.kind(0, ws.base + 4) == 0


def test_workspace_grows_and_is_kept_per_stream():
    a = kernels.workspace(CPU, 1, 5, 32)
    assert a.tiles == 5 and a.buf.numel() == 6 * 32 and a.base == 0
    a.base = 9
    assert kernels.workspace(CPU, 1, 5, 32) is a  # reused, base kept
    b = kernels.workspace(CPU, 2, 5, 32)
    assert b is not a and b.buf.data_ptr() != a.buf.data_ptr()
    grown = kernels.workspace(CPU, 1, 7, 32)
    assert grown.tiles == 10 and grown.base == 0  # doubled, counter at 0
    assert not grown.buf.any()
    assert kernels.workspace(CPU, 1, 23, 32).tiles == 23


def test_workspace_restarts_before_the_stamp_overflows():
    rng = np.random.default_rng(9)
    n = 6 * TILE + 3
    heads = rng.uniform(0, 1, n) < 0.1
    x = rng.uniform(10.0, 1e4, (1, n)).astype(np.float32)
    model_scan(heads, x, rng)
    (ws,) = kernels.workspaces.values()
    limit_base = kernels.STAMP_LIMIT - 3
    ws.base = limit_base
    Records(ws).counter[0] = np.uint64(limit_base)
    got = model_scan(heads, x, rng)  # 7 tiles would pass the limit
    assert ws.base == 7  # zeroed, counter restarted at 0
    want = kernels.seg_scan_plain(torch.from_numpy(heads),
                                  torch.from_numpy(x[0]))
    np.testing.assert_allclose(got[0], want[0].numpy(), rtol=1e-5, atol=0)


def test_threads_on_one_stream_take_their_own_tickets():
    """Two host threads launch on one stream at once.  The lock holds each
    launch's base, its enqueue and its base bump together, so every call
    numbers its tiles from its own base and no tile goes unwritten."""
    def calls(k):
        rng = np.random.default_rng(100 + k)
        done = []
        for _ in range(8):
            n = int(rng.integers(1, 12 * TILE))
            heads = rng.uniform(0, 1, n) < 0.1
            x = rng.uniform(10.0, 1e4, (2, n)).astype(np.float32)
            done.append((heads, x, model_scan(heads, x, rng, window=3)))
        return done

    kernels.workspace(CPU, 0, 12, 32)  # large enough: it never regrows
    with ThreadPoolExecutor(2) as pool:
        results = [r for f in [pool.submit(calls, k) for k in range(2)]
                   for r in f.result()]
    for heads, x, got in results:
        want = kernels.seg_scan_plain(torch.from_numpy(heads),
                                      *(torch.from_numpy(r) for r in x))
        for g, e in zip(got, want):
            np.testing.assert_allclose(g, e.numpy(), rtol=1e-5, atol=0)
    (ws,) = kernels.workspaces.values()
    assert ws.base == sum(-(-x.shape[1] // TILE) for _, x, _ in results)
    assert kernels.launches["seg_scan"] == len(results)


def test_launch_refuses_graph_capture(monkeypatch):
    """A captured launch would replay with the base of its capture."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        model_scan(np.ones(3, bool), np.ones((1, 3), np.float32),
                   np.random.default_rng(0))
    assert not kernels.workspaces and kernels.launches["seg_scan"] == 0
