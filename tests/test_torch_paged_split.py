"""The split over pages of the port's paged decode (flash-decoding) on the
CPU, with the plain versions of its two kernels:

- ``_num_splits`` (the wrapper's choice from shapes alone) stays within
  [1, mpp], leaves no split without a page slot, and gives at least two
  blocks per SM at the serving shape;
- per-split partials (``paged_decode_split_ref``) merged by
  ``paged_decode_combine_ref`` equal ``paged_decode_ref`` within 1e-6 in
  float32 (the same sums, grouped differently) for every split count from
  1 to mpp, on a table with unmapped pages (a whole split of them between
  counted ones), a dead row, lengths 0, on and one short of page
  boundaries, and a slot whose later splits all start past its length;
  float and int8 pools;
- the merged result against the JAX package's ``paged_decode_attention``
  in interpret mode (2e-5, the tolerance of tests/test_torch_paged.py);
- a split with no counted page is the sentinel (o = 0, l = 0, m = -inf)
  and weighs nothing in the combine, whatever its o holds;
- the merge runs inside the split kernel: the port has no separate
  combine wrapper, and ``paged_decode_attention`` on CPU tensors takes
  its plain version and counts no launch;
- the split kernel's ticket counters: the same buffer is reused while it
  holds a call's (slot, kv head) pairs, a larger call gets a new zeroed
  one, a buffer never shrinks, earlier buffers stay held (a captured CUDA
  graph keeps their addresses), and growing while a graph captures
  raises."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops import paged_attention as jpa  # noqa: E402
from kubeflow_tpu_torch.ops import paged_attention as PA  # noqa: E402
from kubeflow_tpu_torch.ops import quantization as tquant  # noqa: E402

MERGE_TOL = 1e-6
ATTN_TOL = 2e-5
B, H, KH, D, PG, MPP = 6, 8, 2, 16, 8, 7
# Slot 0: length 0; 1: the last position of page 0; 2: the first of page 1;
# 3: the last of page 3; 4: inside page 6 with pages 2-5 unmapped (with
# three splits, split 1 is all -1 between counted splits 0 and 2); 5: no
# mapped page (a dead row). Slots 0-3 have splits past their length.
LENGTHS = [0, 7, 8, 31, 50, 40]
UNMAPPED = [(4, 2), (4, 3), (4, 4), (4, 5)]


def _case(quant: bool):
    rng = np.random.default_rng(17)
    P = B * MPP + 3
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    pk = rng.standard_normal((P, PG, KH, D)).astype(np.float32)
    pv = rng.standard_normal((P, PG, KH, D)).astype(np.float32)
    table = rng.permutation(B * MPP).reshape(B, MPP).astype(np.int32)
    for b, j in UNMAPPED:
        table[b, j] = -1
    table[5] = -1
    t = {"q": torch.from_numpy(q), "pool_k": torch.from_numpy(pk),
         "pool_v": torch.from_numpy(pv), "table": torch.from_numpy(table),
         "lengths": torch.tensor(LENGTHS, dtype=torch.int64)}
    if quant:
        t["pool_k"], t["pool_ks"] = tquant.quantize_kv(t["pool_k"])
        t["pool_v"], t["pool_vs"] = tquant.quantize_kv(t["pool_v"])
    return t


def _call(fn, c, *args):
    return fn(c["q"], c["pool_k"], c["pool_v"], c["table"], c["lengths"],
              *args, pool_ks=c.get("pool_ks"), pool_vs=c.get("pool_vs"))


@pytest.mark.parametrize("b,kh,mpp,slots", [
    (1, 1, 1, 396), (1, 8, 16, 396), (8, 8, 16, 396), (8, 8, 16, 660),
    (32, 8, 16, 396), (64, 8, 16, 396), (256, 8, 16, 132), (3, 2, 13, 396),
    (8, 8, 0, 396), (2, 1, 64, 1), (1, 1, 1000, 396)])
def test_num_splits_stays_within_the_page_slots(b, kh, mpp, slots):
    """Between 1 and mpp splits, none of them without a page slot, each
    with as few page slots as the card's block slots allow: as few as
    ceil(slots / (b * kh)) splits would give."""
    splits = PA._num_splits(b, kh, mpp, slots)
    assert 1 <= splits <= max(mpp, 1)
    if mpp:
        pps = -(-mpp // splits)
        assert (splits - 1) * pps < mpp <= splits * pps
        fill = min(mpp, -(-slots // (b * kh)))
        assert pps == -(-mpp // fill)


def test_num_splits_fills_two_waves_at_the_serving_shape():
    """8 slots x 8 kv heads with 16 page slots on 132 SMs, 3 blocks of
    ~71 KB of shared memory each per SM (bf16 pages of 128, 4 query heads
    per kv head): 64 blocks without a split, at least two per SM with
    it."""
    splits = PA._num_splits(8, 8, 16, 3 * 132)
    assert 4 <= splits <= 8
    assert 8 * 8 * splits >= 2 * 132


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("splits", range(1, MPP + 1))
def test_split_partials_merge_to_the_reference(splits, quant):
    c = _case(quant)
    o_part, ml = _call(PA.paged_decode_split_ref, c, splits)
    assert o_part.shape == (B, H, splits, D) and ml.shape == (B, H, splits, 2)
    merged = PA.paged_decode_combine_ref(o_part, ml)
    want = _call(PA.paged_decode_ref, c)
    assert merged.shape == want.shape == (B, 1, H, D)
    err = float((merged - want).abs().max())
    assert err <= MERGE_TOL, f"max abs err {err:.3e}"
    assert not merged[5].any()                   # the dead row


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_merged_splits_match_the_jax_kernel(quant):
    c = _case(quant)
    want = jpa.paged_decode_attention(
        *(jnp.asarray(c[n].numpy()) for n in ("q", "pool_k", "pool_v",
                                              "table")),
        jnp.asarray(c["lengths"].numpy().astype(np.int32)),
        pool_ks=(jnp.asarray(c["pool_ks"].numpy()) if quant else None),
        pool_vs=(jnp.asarray(c["pool_vs"].numpy()) if quant else None),
        interpret=True)
    for splits in (2, 3, MPP):
        merged = PA.paged_decode_combine_ref(
            *_call(PA.paged_decode_split_ref, c, splits))
        err = float(np.max(np.abs(merged.numpy() - np.asarray(want))))
        assert err < ATTN_TOL, f"splits={splits}: max abs err {err:.3e}"


def test_a_split_with_no_counted_page_is_the_sentinel():
    """Three splits of 3, 3 and 1 page slots: slot 0 (length 0) counts
    only page 0, slot 4's split 1 is all unmapped, slot 5 is dead."""
    o_part, ml = _call(PA.paged_decode_split_ref, _case(False), 3)
    dead = [(0, 1), (0, 2), (4, 1), (5, 0), (5, 1), (5, 2)]
    for b, s in dead:
        assert torch.all(ml[b, :, s, 1] == 0)
        assert torch.all(ml[b, :, s, 0] == float("-inf"))
        assert not o_part[b, :, s].any()
    live = [(0, 0), (4, 0), (4, 2), (3, 0), (3, 1)]
    for b, s in live:
        assert torch.all(ml[b, :, s, 1] >= 1)    # the max term is exp(0)
        assert torch.all(torch.isfinite(ml[b, :, s, 0]))


def test_combine_weighs_a_dead_split_as_nothing():
    """Whatever a split with l = 0 holds in o and m (NaN, inf, a larger
    max) leaves the merge unchanged; a row whose splits are all dead is
    zeros."""
    c = _case(False)
    o_part, ml = _call(PA.paged_decode_split_ref, c, 3)
    want = PA.paged_decode_combine_ref(o_part, ml)
    o2, ml2 = o_part.clone(), ml.clone()
    o2[0, :, 1] = float("nan")
    o2[4, :, 1] = float("inf")
    ml2[0, :, 2, 0] = 1e30                       # l stays 0
    got = PA.paged_decode_combine_ref(o2, ml2)
    assert torch.equal(got, want)
    assert not got[5].any()


def test_the_merge_has_no_wrapper_of_its_own():
    """The splits are merged inside the split kernel: no combine wrapper
    or launch counter is left, and a CPU call takes the plain version and
    counts no launch."""
    assert not hasattr(PA, "paged_decode_combine")
    c = _case(False)
    before = PA.paged_decode_attention.launches
    got = _call(PA.paged_decode_attention, c)
    assert PA.paged_decode_attention.launches == before
    assert torch.equal(got, _call(PA.paged_decode_ref, c))


@pytest.mark.parametrize("have,n", [
    (None, 1), (None, 64), (64, 64), (64, 8), (64, 65), (8, 256), (256, 0)])
def test_ticket_counters_grow_with_zeros_and_never_shrink(have, n):
    cpu = torch.device("cpu")
    old = None if have is None else torch.full((have,), 7, dtype=torch.int32)
    got = PA._grown(old, n, cpu)
    assert got.dtype == torch.int32 and got.device == cpu
    if old is not None and have >= n:
        assert got is old                            # reused as it is
    else:
        assert got is not old
        assert got.numel() == max(n, 0 if have is None else have)
        assert not got.any()                         # new zeros
    assert got.numel() >= max(n, 0 if have is None else have)


def test_ticket_counters_are_kept_per_device(monkeypatch):
    """``_tickets`` hands out one buffer per device, grows it for a call
    with more (slot, kv head) pairs, keeps the earlier buffers, and raises
    rather than grow while a CUDA graph is capturing."""
    monkeypatch.setattr(PA, "_TICKETS", {})
    capturing = [False]
    monkeypatch.setattr(PA.torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    cpu = torch.device("cpu")
    first = PA._tickets(cpu, 64)
    assert first.numel() == 64 and PA._tickets(cpu, 8) is first
    capturing[0] = True
    assert PA._tickets(cpu, 64) is first             # no growth: allowed
    with pytest.raises(RuntimeError, match="capturing"):
        PA._tickets(cpu, 65)
    capturing[0] = False
    second = PA._tickets(cpu, 65)
    assert second.numel() == 65 and not second.any()
    held = PA._TICKETS[cpu]
    assert len(held) == 2 and held[0] is first and held[1] is second
    assert PA._tickets(cpu, 64) is second
