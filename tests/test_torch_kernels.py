"""The port's seg_mean and seg_scan against the JAX package's
seg_mean_pallas, seg_scan_pallas and segments.seg_scan.

On the CPU the wrappers run their plain PyTorch versions; the Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Counts are sums of 0/1 weights and must match exactly; means and prefix
sums of positive values within rtol 1e-5 (float32 sums in another order
than the float64 plain prefixes)."""

import numpy as np
import pytest
import torch

from specpride_tpu.ops import pallas_kernels as pk
from specpride_tpu.ops import segments as jsegments
from specpride_tpu_torch.ops import _build, kernels


def _runs(rng, n, lo, hi):
    lens = []
    while sum(lens) < n:
        lens.append(int(rng.integers(lo, hi)))
    return np.repeat(np.arange(len(lens)), lens)[:n].astype(np.int32)


def _case(name, rng):
    """(keys, w) for one named layout; values are drawn by the caller."""
    if name == "straddle":  # random runs, many across the block edge
        n = 2 * pk.BLK
        keys = _runs(rng, n, 1, pk.BLK // 3)
        w = np.ones(n, np.float32)
    elif name == "masked":  # path-like runs of 1-20 with masked slots
        n = 2 * pk.BLK
        keys = _runs(rng, n, 1, 21)
        w = (rng.uniform(0, 1, n) < 0.8).astype(np.float32)
    elif name == "masked_run":  # one run masked from its start
        n = 2 * pk.BLK
        keys = _runs(rng, n, 1, 21)
        w = np.ones(n, np.float32)
        w[keys == keys[pk.BLK]] = 0.0
    elif name == "long_run":  # one run across four blocks, then a tail
        n = 5 * pk.BLK
        keys = np.zeros(n, np.int32)
        keys[4 * pk.BLK + 7:] = 1
        w = np.ones(n, np.float32)
    elif name == "pad_tail":  # non-negative keys, then a -1 padding tail
        n = 2 * pk.BLK
        keys = _runs(rng, n, 1, 21)
        keys[n - pk.BLK // 2 - 3:] = -1
        w = (keys >= 0).astype(np.float32)
    else:
        raise ValueError(name)
    return keys, w


CASES = ["straddle", "masked", "masked_run", "long_run", "pad_tail"]


@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_seg_mean_plain_matches_pallas(case, nv):
    rng = np.random.default_rng(CASES.index(case) * 10 + nv)
    keys, w = _case(case, rng)
    n = keys.size
    values = [rng.uniform(10.0, 1e4, n).astype(np.float32) for _ in range(nv)]
    before = kernels.launches["seg_mean"]

    want = [np.asarray(o) for o in
            pk.seg_mean_pallas(keys, w, *values, interpret=True)]
    got = [o.numpy() for o in kernels.seg_mean(
        *(torch.from_numpy(a) for a in (keys, w, *values))
    )]

    assert kernels.launches["seg_mean"] == before  # CPU: no launch
    assert len(got) == 1 + nv
    np.testing.assert_array_equal(got[0], want[0])
    for g, e in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=0)
    if case == "masked_run":
        masked = keys == keys[pk.BLK]
        assert (got[0][masked] == 0).all() and (got[1][masked] == 0).all()
    if case == "long_run":
        assert got[0][4 * pk.BLK + 6] == 4 * pk.BLK + 7
        assert got[0][-1] == pk.BLK - 7


def test_seg_mean_plain_reads_masked_slot_inside_run():
    """A zero-weight slot inside a run reads the count of the valid slots
    before it (the Pallas body's prefix), not 0."""
    keys = torch.tensor([3, 3, 3, 4], dtype=torch.int32)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])
    x = torch.tensor([2.0, 100.0, 4.0, 8.0])
    cnt, mean = kernels.seg_mean(keys, w, x)
    assert cnt.tolist() == [1.0, 1.0, 2.0, 1.0]
    assert mean.tolist() == [2.0, 2.0, 3.0, 8.0]


@pytest.mark.parametrize(
    "bad",
    ["keys_dtype", "w_dtype", "length", "channels", "two_dim"],
)
def test_seg_mean_rejects_bad_arguments(bad):
    keys = torch.zeros(8, dtype=torch.int32)
    w = torch.ones(8)
    x = torch.ones(8)
    args = {
        "keys_dtype": (keys.long(), w, x),
        "w_dtype": (keys, w.double(), x),
        "length": (keys, w, torch.ones(7)),
        "channels": (keys, w, x, x, x),
        "two_dim": (keys.view(2, 4), w.view(2, 4), x.view(2, 4)),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        kernels.seg_mean(*args)


@pytest.mark.parametrize("case", ["straddle", "long_run", "pad_tail"])
def test_seg_scan_plain_matches_pallas(case):
    """The keys entry against seg_scan_pallas: random runs across the
    block edge, one run across four blocks, and a -1 padding tail."""
    rng = np.random.default_rng(100 + CASES.index(case))
    keys, _ = _case(case, rng)
    n = keys.size
    values = [rng.uniform(10.0, 1e4, n).astype(np.float32) for _ in range(3)]
    before = kernels.launches["seg_scan"]

    want = pk.seg_scan_pallas(keys, *values, interpret=True)
    got = kernels.seg_scan(*(torch.from_numpy(a) for a in (keys, *values)))

    assert kernels.launches["seg_scan"] == before  # CPU: no launch
    assert len(got) == 3
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=0)
    if case == "long_run":
        np.testing.assert_allclose(
            got[0][4 * pk.BLK + 6].item(),
            values[0][: 4 * pk.BLK + 7].astype(np.float64).sum(), rtol=1e-6,
        )


@pytest.mark.parametrize("flags", ["bool", "uint8", "no_first_head"])
@pytest.mark.parametrize("nc", [1, 2, 3])
def test_seg_scan_flags_matches_xla_scan(nc, flags):
    """The flags entry against segments.seg_scan with lcap >= the longest
    run; element 0 begins a run whether or not its flag is set."""
    rng = np.random.default_rng(10 * nc + len(flags))
    n = 5000
    starts = rng.uniform(0, 1, n) < 0.15
    starts[1000:1700] = False  # one run of 700
    if flags == "no_first_head":
        starts[0] = False
    bounds = np.flatnonzero(np.concatenate([[True], starts[1:], [True]]))
    lcap = 1 << int(np.diff(bounds).max() - 1).bit_length()
    values = [rng.uniform(0.1, 1e4, n).astype(np.float32) for _ in range(nc)]

    want = jsegments.seg_scan(starts, tuple(values), lcap)
    runs = torch.from_numpy(starts)
    if flags == "uint8":
        runs = runs.to(torch.uint8)
    got = kernels.seg_scan(runs, *(torch.from_numpy(v) for v in values))

    assert len(got) == nc
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=0)


@pytest.mark.parametrize(
    "bad",
    ["keys_dtype", "value_dtype", "length", "no_channels", "four_channels",
     "two_dim"],
)
def test_seg_scan_rejects_bad_arguments(bad):
    keys = torch.zeros(8, dtype=torch.int32)
    x = torch.ones(8)
    args = {
        "keys_dtype": (keys.long(), x),
        "value_dtype": (keys, x.double()),
        "length": (keys, torch.ones(7)),
        "no_channels": (keys,),
        "four_channels": (keys, x, x, x, x),
        "two_dim": (keys.view(2, 4), x.view(2, 4)),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        kernels.seg_scan(*args)


def _head_values(dtypes, n, rng):
    """numpy channels for ``dtypes`` and the tensors the wrapper takes
    (bf16 from int16 bit patterns of rounded float32 values)."""
    arrays, tensors = [], []
    for dt in dtypes:
        if dt == torch.int8:
            a = rng.integers(-127, 128, n).astype(np.int8)
            t = torch.from_numpy(a)
        else:
            a = rng.uniform(10.0, 1e4, n).astype(np.float32)
            t = torch.from_numpy(a)
            if dt == torch.bfloat16:
                t = t.to(torch.bfloat16)
                a = t.to(torch.float32).numpy()
        arrays.append(a)
        tensors.append(t)
    return arrays, tensors


HEAD_CASES = [tuple(str(d).removeprefix("torch.") for d in c)
              for c in kernels.HEAD_CASES]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtypes", HEAD_CASES, ids="-".join)
def test_seg_mean_heads_plain_equals_keyed_plain(dtypes, case):
    """``seg_mean_heads`` on head flags is ``seg_mean`` on the cumsum key
    of the same heads with unit weights (as the JAX package feeds
    seg_mean_pallas), the channels upcast to float32: equal."""
    rng = np.random.default_rng(len(case) + 7 * len(dtypes))
    keys, _ = _case(case, rng)
    heads = np.ones(keys.size, np.uint8)
    heads[1:] = keys[1:] != keys[:-1]
    arrays, tensors = _head_values(
        [getattr(torch, d) for d in dtypes], keys.size, rng)
    before = kernels.launches["seg_mean_heads"]
    got = kernels.seg_mean_heads(torch.from_numpy(heads), *tensors)
    key = (np.cumsum(heads) - 1).astype(np.int32)
    want = kernels.seg_mean_plain(
        torch.from_numpy(key), torch.ones(keys.size),
        *(torch.from_numpy(a.astype(np.float32)) for a in arrays))
    assert kernels.launches["seg_mean_heads"] == before  # CPU: no launch
    assert len(got) == len(want) == 1 + len(dtypes)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


@pytest.mark.parametrize("nv", [1, 2])
def test_seg_mean_heads_plain_matches_pallas(nv):
    """Against seg_mean_pallas fed the cumsum key of the heads and unit
    weights, as ``_bin_mean_flat_q`` does: counts equal, means within rtol
    1e-5."""
    rng = np.random.default_rng(40 + nv)
    keys, _ = _case("straddle", rng)
    heads = np.ones(keys.size, bool)
    heads[1:] = keys[1:] != keys[:-1]
    dtypes = [torch.int8] if nv == 1 else [torch.float32, torch.bfloat16]
    arrays, tensors = _head_values(dtypes, keys.size, rng)
    key = (np.cumsum(heads) - 1).astype(np.int32)
    want = [np.asarray(o) for o in pk.seg_mean_pallas(
        key, np.ones(keys.size, np.float32),
        *(a.astype(np.float32) for a in arrays), interpret=True)]
    got = [o.numpy() for o in kernels.seg_mean_heads(
        torch.from_numpy(heads), *tensors)]
    np.testing.assert_array_equal(got[0], want[0])
    for g, e in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=0)


def test_seg_mean_heads_first_element_always_begins_a_run():
    head = torch.tensor([0, 0, 1, 0], dtype=torch.uint8)
    x = torch.tensor([2, 4, 6, 8], dtype=torch.int8)
    cnt, mean = kernels.seg_mean_heads(head, x)
    assert cnt.tolist() == [1.0, 2.0, 1.0, 2.0]
    assert mean.tolist() == [2.0, 3.0, 6.0, 7.0]
    empty = kernels.seg_mean_heads(torch.zeros(0, dtype=torch.bool),
                                   torch.zeros(0, dtype=torch.bfloat16))
    assert [t.shape for t in empty] == [(0,), (0,)]


@pytest.mark.parametrize(
    "bad",
    ["head_dtype", "one_f32", "bf16_after_int8", "int8_mz", "bf16_mz_f32",
     "length", "no_channels", "three_channels", "two_dim"],
)
def test_seg_mean_heads_rejects_bad_arguments(bad):
    head = torch.ones(8, dtype=torch.uint8)
    f, b, i = torch.ones(8), torch.ones(8, dtype=torch.bfloat16), \
        torch.ones(8, dtype=torch.int8)
    args = {
        "head_dtype": (head.int(), b),
        # one f32 channel is a kernel case (the flat gap average's), but
        # only as a flat channel beside the flat head flags
        "one_f32": (head, f.view(2, 4)),
        "bf16_after_int8": (head, i, b),
        "int8_mz": (head, i, f),
        "bf16_mz_f32": (head, b, f),  # f32 intensity only beside f32 m/z
        "length": (head, torch.ones(7, dtype=torch.int8)),
        "no_channels": (head,),
        "three_channels": (head, f, f, i),
        "two_dim": (head.view(2, 4), b.view(2, 4)),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        kernels.seg_mean_heads(*args)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper sees when
    it is handed card tensors on a host with no kernel library."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("wrapper", ["seg_mean", "seg_scan",
                                     "seg_mean_heads"])
def test_cuda_tensors_without_kernel_library_raise(wrapper, monkeypatch):
    """On CUDA tensors a wrapper launches its kernel or raises: with no
    kernel library it raises, and never falls back to the plain version."""

    def no_library():
        raise RuntimeError("no kernel library")

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(kernels, f"{wrapper}_plain", plain)
    if wrapper == "seg_mean_heads":
        args = (torch.ones(8, dtype=torch.uint8),
                torch.ones(8, dtype=torch.int8))
    else:
        x = torch.ones(8)
        args = (torch.zeros(8, dtype=torch.int32), x, x)
    before = dict(kernels.launches)
    with pytest.raises(RuntimeError, match="no kernel library"):
        getattr(kernels, wrapper)(*(t.as_subclass(_CudaLooking)
                                    for t in args))
    assert kernels.launches == before
