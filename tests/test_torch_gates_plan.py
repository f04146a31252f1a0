"""The gate kernel's plan and a CPU model of its streaming bodies' walk.

``ops/convlstm_gates.py::gates_plan`` picks the body of ``csrc/lstm_gates.cu``
per launch; the kernel cannot run here, so these tests hold a numpy model
of what its vector and slab bodies do (the persistent grid's walk, the
slab ring's stages, the 16-byte vectors and granules, the element-wise
head and tail, the multiply-shift division) to cover every element of
``(npix, C)`` exactly once, and the model, run with the plain version's
math on what it reads, to equal ``lstm_gates_plain`` bit for bit.  The
card holds the kernel itself bit-equal to its scalar body
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates as cg
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import GatesPlan
from evolutionary_illusion_generator_tpu_torch.scripts import gates_breakdown as gb
from evolutionary_illusion_generator_tpu_torch.utils.profiling import PORT_KERNELS

SOURCE = (Path(cg.__file__).resolve().parent.parent / "csrc" / "lstm_gates.cu").read_text()
BF16, F32 = torch.bfloat16, torch.float32
TYPES = list(itertools.product((F32, BF16), repeat=3))  # (gates, state, out)
CHANNELS = (1, 3, 8, 12, 48, 96, 192)
SMALL_PIXELS = (1, 7 * 9, 63 * 8 + 5)
# the north star's calls of the kernel (B x H x W, C): the True route's four
# layers and the s2d pixel layer, at a chunk of 25
NORTH_STAR = ((25 * 480 * 640, 3), (25 * 240 * 320, 48), (25 * 120 * 160, 96),
              (25 * 60 * 80, 192), (25 * 240 * 320, 12))
THREADS = cg.STREAM_THREADS


# ---- the kernel's arithmetic, as the source has it -------------------------


def divisor(d):
    """``make_divisor``: (d, m, s) with s = 31 + ceil(log2 d), m = ceil(2^s / d)."""
    s = 31 + (d - 1).bit_length()
    return d, -(-(1 << s) // d), s


def quotient(n, div):
    """``quotient``: (n m) >> s in 64 bits, for numpy arrays of n < 2^31."""
    _, m, s = div
    return (np.asarray(n, np.uint64) * np.uint64(m)) >> np.uint64(s)


def size(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def test_the_source_has_the_models_constants():
    """The model's numbers are the kernel's: threads a block, the
    divisor's formula, a stage's bytes and the C entry's body codes."""
    assert re.search(r"constexpr int STREAM_THREADS = (\d+);", SOURCE).group(1) == str(THREADS)
    assert "const unsigned s = 31 + k;" in SOURCE
    assert "(((1ull << s) + d - 1) / d)" in SOURCE
    assert "(bytes + 15) / 16 * 16 + 16" in SOURCE
    assert "enum Body { SCALAR = 0, VECTOR = 1, SLAB = 2 };" in SOURCE
    assert f"if (smem > {cg.SMEM_PER_BLOCK}) return (int)cudaErrorInvalidValue;" in SOURCE
    assert cg.BODIES == ("scalar", "vector", "slab")
    # each body's kernel by name, in BODIES' order, as the profiles and the
    # breakdown's SASS count find them
    names = PORT_KERNELS["fused_lstm_gates"]
    assert all(f"{name}(const GT* __restrict__ gates" in SOURCE for name in names)
    assert dict(zip(names, cg.BODIES)) == gb._KERNELS


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 8, 12, 24, 36, 48, 96, 192, 1000, 2**31 - 1])
def test_divisor_is_exact(d):
    """n / d by the multiply and shift equals the division for n < 2^31: the
    first and last 2^20 values and 2^20 drawn between."""
    div = divisor(d)
    assert div[1] < 2**32
    rng = np.random.default_rng(d)
    for n in (np.arange(2**20), np.arange(2**31 - 2**20, 2**31),
              rng.integers(0, 2**31, 2**20)):
        np.testing.assert_array_equal(quotient(n, div), n // d)


# ---- the plan ----------------------------------------------------------------


@pytest.mark.parametrize("types", TYPES)
@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_picks_the_body_from_shape_types_and_alignment(C, types, aligned):
    """The vector body where C is a multiple of its width and the pointers
    are aligned, else the slab body, with slabs that a block's
    shared memory holds; the scalar body only at or below
    ``SCALAR_MAX_ELEMENTS``; every plan's grid a multiple of the SMs where
    the call has that many blocks of work, and the slab body's shared
    memory within an SM's."""
    V = cg.vector_width(*types)
    assert V == (8 if types == (BF16, BF16, BF16) else 4)
    for npix in (*SMALL_PIXELS, 8 * 120 * 160, 25 * 480 * 640):
        plan = cg.gates_plan(npix, C, *types, aligned)
        plans = cg.body_plans(npix, C, *types, aligned)
        assert plans["scalar"] == GatesPlan("scalar") and "slab" in plans
        assert ("vector" in plans) == (aligned and C % V == 0)
        if npix * C <= cg.SCALAR_MAX_ELEMENTS:
            assert plan == GatesPlan("scalar")
            continue
        assert plan == plans[next(b for b in cg.PREFERENCE if b in plans)]
        if "vector" in plans:
            blocks = -(-npix * C // V // THREADS)
            grid = min(blocks, cg.SMS * cg.BLOCKS_PER_SM["vector"])
            assert plans["vector"] == GatesPlan("vector", 0, 0, grid)
        slab = plans["slab"]
        P = slab.slab_pixels
        assert slab.ring == cg.SLAB_RING
        smem = cg.slab_smem(P, C, *types, slab.ring)
        assert smem <= cg.SMEM_PER_BLOCK
        if P % 16 == 0:  # about SLAB_ELEMENTS, a multiple of 16 pixels
            assert P * C >= cg.SLAB_ELEMENTS > (P - 16) * C
        else:  # halved from there until the warps' rings fit a block
            assert cg.slab_smem(2 * P, C, *types, slab.ring) > cg.SMEM_PER_BLOCK
        per_sm = slab.grid // cg.SMS
        warps = -(-npix // P)  # slabs, one warp's each
        assert 1 <= slab.grid <= -(-warps // cg.SLAB_WARPS)
        assert slab.grid == -(-warps // cg.SLAB_WARPS) or (
            slab.grid % cg.SMS == 0 and per_sm <= cg.BLOCKS_PER_SM["slab"]
            and per_sm * (smem + cg.SMEM_RESERVED) <= cg.SMEM_PER_SM)


def test_plan_at_the_shapes_where_the_kernel_runs():
    """The north star's True-route pixel layer and s2d pixel layer on the
    slab body, its layers 1-3 on the vector body, in bfloat16; the JAX
    function's float32 contract at C 12 (4-wide vectors) on the vector
    body; a view off alignment on the slab body."""
    bodies = [cg.gates_plan(npix, C).body for npix, C in NORTH_STAR]
    assert bodies == ["slab", "vector", "vector", "vector", "slab"]
    assert cg.gates_plan(25 * 240 * 320, 12, F32, BF16, F32).body == "vector"
    assert cg.gates_plan(25 * 240 * 320, 48, aligned=False).body == "slab"


def test_plan_shrinks_the_slab_for_wide_channels_off_alignment():
    """Wide C on views off alignment: slabs of fewer pixels, until the
    warps' rings fit a block; the scalar body where not one pixel's does."""
    plan = cg.gates_plan(4096, 192, F32, F32, F32, aligned=False)
    assert plan.body == "slab" and plan.slab_pixels == 2
    assert cg.gates_plan(4096, 192, F32, F32, F32, aligned=True).body == "vector"
    assert cg.gates_plan(64, 4099, F32, F32, F32, aligned=False) == GatesPlan("scalar")


def test_slab_smem_is_the_kernels_layout():
    """Each warp's ring stages of the gates and the state, then its h and
    c, each rounded up to 16 bytes plus one granule for the offset."""
    W = cg.SLAB_WARPS
    assert cg.slab_smem(352, 3, BF16, BF16, BF16, 3) == W * (
        3 * ((352 * 12 * 2 + 16) + (352 * 3 * 2 + 16)) + 2 * (352 * 3 * 2 + 16))
    assert cg.slab_smem(16, 1, F32, BF16, F32, 2) == W * (
        2 * ((256 + 16) + (32 + 16)) + 2 * (64 + 16))
    assert re.search(r"constexpr int SLAB_WARPS = STREAM_THREADS / 32;", SOURCE)


# ---- the walk -----------------------------------------------------------------


def vector_walk(nvec, grid):
    """Every vector index the vector body's threads take: thread t of block
    b from b * THREADS + t, striding by the grid's threads."""
    stride = grid * THREADS
    starts = np.arange(min(stride, nvec), dtype=np.int64)
    trips = (nvec - starts + stride - 1) // stride
    return np.repeat(starts, trips) + stride * (
        np.arange(trips.sum()) - np.repeat(np.cumsum(trips) - trips, trips))


def slab_walk(nslabs, grid, ring):
    """The slab body's slabs as (warp of the grid, slab) in the order each
    warp computes them, each from the ring's stage it was loaded into:
    warp w of block b starts at b SLAB_WARPS + w and strides by the grid's
    warps; its prologue loads its first ring - 1 slabs into stages 0 ..
    ring - 2, and the iteration of slab s loads the slab ring - 1 strides
    on into the stage before s's.  Raises where a warp would compute a slab
    whose stage holds another."""
    done, step = [], grid * cg.SLAB_WARPS
    for w in range(min(step, nslabs)):
        stage = {k: w + k * step for k in range(ring - 1)}
        k = 0
        for s in range(w, nslabs, step):
            stage[(k + ring - 1) % ring] = s + (ring - 1) * step
            assert stage[k] == s, (w, s, stage)
            done.append((w, s))
            k = (k + 1) % ring
    return np.array(done, np.int64).reshape(-1, 2)


def granules(a, count, es):
    """``stage_in`` / ``stage_out``'s split of the byte range of ``count``
    elements of ``es`` bytes at address ``a``: the 16-byte interior
    granules' addresses, and the head and tail elements' addresses."""
    e = a + count * es
    a0, a1 = min((a + 15) & ~15, e), max(e & ~15, min((a + 15) & ~15, e))
    inner = list(range(a0, a1, 16))
    head = list(range(a, a0, es))
    tail = list(range(a1, e, es))
    return inner, head + tail


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("npix,C",
                         [(n, c) for n in SMALL_PIXELS for c in CHANNELS] + list(NORTH_STAR))
def test_walk_covers_every_element_once(npix, C, offset):
    """At each pixel count, C and offset (elements past a 16-byte boundary
    of the gates and the state), in bfloat16 and in the float32 contract,
    every streaming body that takes the call: the vector body visits every
    vector once, a vector's pixel and channel from
    the multiply-shift division; the slab body every slab once, a slab's
    elements from its warp's lanes once each, their gate addresses in
    shared memory those of their pixel and channel, each slab's bytes, in
    and out, split into aligned granules and a head and tail of under 16
    bytes that tile the range."""
    n = npix * C
    contracts = [(BF16, BF16, BF16)] + ([(F32, BF16, F32)] if npix in SMALL_PIXELS else [])
    for types in contracts:
        aligned = offset == 0
        V = cg.vector_width(*types)
        plans = [p for b, p in cg.body_plans(npix, C, *types, aligned).items() if b != "scalar"]
        for p in plans:
            if p.body == "vector":
                nvec = n // V
                j = vector_walk(nvec, p.grid)
                assert np.bincount(j, minlength=nvec).max() == 1 and len(j) == nvec
                per = C // V
                pix = quotient(j, divisor(per)).astype(np.int64)
                k = j - pix * per
                assert ((k >= 0) & (k < per)).all() and (pix < npix).all()
                continue
            P = p.slab_pixels
            nslabs = -(-npix // P)
            s = slab_walk(nslabs, p.grid, p.ring)[:, 1]
            assert sorted(s.tolist()) == list(range(nslabs))
            div = divisor(C)
            for slab in sorted({0, nslabs // 2, nslabs - 1}):
                p0 = slab * P
                ne = min(P, npix - p0) * C
                e = np.concatenate([np.arange(t, ne, 32) for t in range(32)])  # a warp's lanes
                assert np.bincount(e, minlength=ne).max() == 1 and len(e) == ne
                lp = quotient(e, div).astype(np.int64)
                assert (lp * 3 * C + e == lp * 4 * C + (e - lp * C)).all()
                assert ((e - lp * C >= 0) & (e - lp * C < C)).all()
                # the bytes of each tensor's slab (gates 4C a pixel, the state
                # and an output C), with the view's offset
                for width, dtype, off in ((4, types[0], offset), (1, types[1], offset),
                                          (1, types[2], 0)):
                    es, count = size(dtype), width * ne
                    a = 4096 + off * es + width * p0 * C * es
                    inner, edges = granules(a, count, es)
                    covered = [x for g in inner for x in range(g, g + 16)]
                    covered += [x for g in edges for x in range(g, g + es)]
                    assert sorted(covered) == list(range(a, a + count * es))
                    assert all(g % 16 == 0 for g in inner) and len(edges) * es < 32


# ---- the model, with the plain version's math -----------------------------------


class Memory:
    """The card's memory as bytes: tensors placed at chosen offsets past a
    16-byte boundary, every other byte NaN-filled (0xff)."""

    def __init__(self, nbytes):
        self.mem = np.full(nbytes, 0xFF, np.uint8)
        self.top = 0

    def place(self, t, offset_elements):
        es = t.element_size()
        a = -(-self.top // 16) * 16 + offset_elements * es
        raw = t.contiguous().view(torch.int16 if es == 2 else torch.int32).numpy().view(np.uint8)
        self.mem[a:a + raw.size] = raw.ravel()
        self.top = a + raw.size + 64
        return a

    def empty(self, numel, dtype, offset_elements=0):
        es = size(dtype)
        a = -(-self.top // 16) * 16 + offset_elements * es
        self.top = a + numel * es + 64
        return a

    def read(self, a, numel, dtype):
        es = size(dtype)
        raw = self.mem[a:a + numel * es].copy().view(np.int16 if es == 2 else np.int32)
        return torch.from_numpy(raw).view(dtype)


def _stage_in(mem, smem, dst, a, count, es):
    """``stage_in``: the interior granules and the head and tail elements of
    ``count`` elements at ``a`` into ``smem`` at ``dst`` + (a & 15); returns
    where element 0 landed."""
    base = a & ~15
    inner, edges = granules(a, count, es)
    for g in inner:
        assert g % 16 == 0 and (dst + g - base) % 16 == 0
        smem[dst + g - base:dst + g - base + 16] = mem.mem[g:g + 16]
    for x in edges:
        smem[dst + x - base:dst + x - base + es] = mem.mem[x:x + es]
    return dst + (a & 15)


def _stage_out(mem, smem, src, a, count, es):
    base = a & ~15
    inner, edges = granules(a, count, es)
    for g in inner:
        mem.mem[g:g + 16] = smem[src + g - base:src + g - base + 16]
    for x in edges:
        mem.mem[x:x + es] = smem[src + x - base:src + x - base + es]


def _gather(buf, addrs, count, dtype):
    """``count`` elements of ``dtype`` at each byte address of ``addrs`` in
    ``buf``: a tensor (len(addrs), count)."""
    es = size(dtype)
    idx = np.asarray(addrs, np.int64)[:, None] + np.arange(count * es)
    raw = buf[idx].reshape(len(idx), count * es).copy()
    return torch.from_numpy(raw.view(np.int16 if es == 2 else np.int32)).view(dtype)


def run_model(gates, c_prev, out_dtype, plan, offsets):
    """The streaming body of ``plan`` on a model of the card's memory, with
    the gates and the state ``offsets`` elements past a 16-byte boundary
    and h and c at 0 and 3: what each element reads is gathered (shared
    memory for the slab body, packs for the vector body), the plain
    version's math runs on those values, and each element's h and c go
    back out the way the body writes them.  Returns (h, c, the gates and
    state as read)."""
    npix, C = c_prev.shape
    gd, sd, od = gates.dtype, c_prev.dtype, out_dtype
    mem = Memory(npix * C * 40 + 4096)
    ga, sa = mem.place(gates, offsets[0]), mem.place(c_prev, offsets[1])
    # the wrapper's outputs are fresh allocations; the slab body takes any
    ha = mem.empty(npix * C, od, 0)
    ca = mem.empty(npix * C, od, 3 if plan.body == "slab" else 0)
    read_g = torch.full((npix * 4 * C,), float("nan"), dtype=gd)
    read_s = torch.full((npix * C,), float("nan"), dtype=sd)
    writes = []  # (element range start, h smem or pack source, ...) replayed after the math

    if plan.body == "vector":
        V = cg.vector_width(gd, sd, od)
        per = C // V
        j = vector_walk(npix * C // V, plan.grid)
        p = quotient(j, divisor(per)).astype(np.int64)
        first = p * 4 * C + (j - p * per) * V  # gate i's first element of the vector
        lanes = np.arange(V)
        for g in range(4):
            addrs = ga + (first + g * C) * size(gd)
            assert (addrs % (V * size(gd)) == 0).all()
            read_g[torch.from_numpy((first + g * C)[:, None] + lanes)] = _gather(
                mem.mem, addrs, V, gd)
        addrs = sa + j * V * size(sd)
        assert (addrs % (V * size(sd)) == 0).all()
        read_s[torch.from_numpy(j[:, None] * V + lanes)] = _gather(mem.mem, addrs, V, sd)
        writes += [("pack", int(x) * V, V) for x in j]
    else:
        P, ring = plan.slab_pixels, plan.ring
        gate_bytes = -(-P * 4 * C * size(gd) // 16) * 16 + 16
        stage = gate_bytes + -(-P * C * size(sd) // 16) * 16 + 16
        out_bytes = -(-P * C * size(od) // 16) * 16 + 16
        per_warp = ring * stage + 2 * out_bytes
        smem = np.full(cg.SLAB_WARPS * per_warp, 0xFF, np.uint8)
        assert len(smem) == cg.slab_smem(P, C, gd, sd, od, ring)
        div = divisor(C)
        for w, s in slab_walk(-(-npix // P), plan.grid, ring):
            p0 = int(s) * P
            # the warp's ring (the stage's order is slab_walk's to hold)
            base = (int(w) % cg.SLAB_WARPS) * per_warp + (int(s) // (plan.grid * cg.SLAB_WARPS)
                                                          % ring) * stage
            n = min(P, npix - p0)
            g0 = _stage_in(mem, smem, base, ga + p0 * 4 * C * size(gd), n * 4 * C, size(gd))
            s0 = _stage_in(mem, smem, base + gate_bytes, sa + p0 * C * size(sd), n * C,
                           size(sd))
            e = np.arange(n * C)
            lp = quotient(e, div).astype(np.int64)
            for g in range(4):
                addrs = g0 + (lp * 3 * C + e + g * C) * size(gd)
                read_g[torch.from_numpy(p0 * 4 * C + lp * 4 * C + (e - lp * C) + g * C)] = \
                    _gather(smem, addrs, 1, gd)[:, 0]
            read_s[torch.from_numpy(p0 * C + e)] = _gather(smem, s0 + e * size(sd), 1, sd)[:, 0]
            writes.append(("slab", p0 * C, n * C))

    h_ref, c_ref = cg.lstm_gates_plain(read_g.view(npix, 4 * C), read_s.view(npix, C),
                                       out_dtype=od)
    hb, cb = h_ref.view(torch.int16 if size(od) == 2 else torch.int32).numpy(), \
        c_ref.view(torch.int16 if size(od) == 2 else torch.int32).numpy()
    es = size(od)
    for kind, e0, count in writes:
        if kind == "pack":
            for out, a in ((hb, ha), (cb, ca)):
                dst = a + e0 * es
                assert dst % (count * es) == 0
                mem.mem[dst:dst + count * es] = out.ravel()[e0:e0 + count].view(np.uint8)
        else:
            buf = np.full(2 * (-(-count * es // 16) * 16 + 16), 0xFF, np.uint8)
            half = len(buf) // 2
            for out, a, at in ((hb, ha, 0), (cb, ca, half)):
                dst = a + e0 * es
                start = at + (dst & 15)
                buf[start:start + count * es] = out.ravel()[e0:e0 + count].view(np.uint8)
                _stage_out(mem, buf, at, dst, count, es)
    h, c = mem.read(ha, npix * C, od), mem.read(ca, npix * C, od)
    return h.view(npix, C), c.view(npix, C), read_g.view(npix, 4 * C), read_s.view(npix, C)


def _model_plans(npix, C, types, aligned):
    plans = [p for p in (GatesPlan("slab", 16, 2, 1), GatesPlan("slab", 32, 3, 3))
             if cg.slab_smem(p.slab_pixels, C, *types, p.ring) <= cg.SMEM_PER_BLOCK]
    for body, p in cg.body_plans(npix, C, *types, aligned).items():
        if body != "scalar":
            plans += [p, p._replace(grid=2)]
    return plans


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("types", [(BF16, BF16, BF16), (F32, BF16, F32), (BF16, F32, BF16)])
@pytest.mark.parametrize("C", CHANNELS)
def test_model_with_the_plain_math_equals_the_plain_version(C, types, offset):
    """The model of each streaming body (each of ``body_plans``' at its grid
    and on two blocks, slabs of 16 through a ring of two on one block and
    of 32 through three on three blocks) reads exactly the gates and
    state, and its h
    and c, with the plain version's math, equal ``lstm_gates_plain``'s bit
    for bit, at 7 x 9 and 63 x 8 + 5 pixels, aligned and one element off."""
    gd, sd, od = types
    rng = np.random.default_rng(C)
    for npix in SMALL_PIXELS[1:]:
        gates = torch.from_numpy(rng.normal(0, 2, (npix, 4 * C)).astype(np.float32)).to(gd)
        c_prev = torch.from_numpy(rng.normal(0, 1, (npix, C)).astype(np.float32)).to(sd)
        want = cg.lstm_gates_plain(gates, c_prev, out_dtype=od)
        for plan in _model_plans(npix, C, types, offset == 0):
            h, c, g, s = run_model(gates, c_prev, od, plan, (offset, offset))
            assert torch.equal(g, gates) and torch.equal(s, c_prev), plan
            assert torch.equal(h, want[0]) and torch.equal(c, want[1]), plan


def test_chip_smoke_counts_the_gate_kernel_by_body():
    """``chip_smoke.py`` expects the gate kernel's launches on each call's
    plan body: the True route's four layers at a shard's rows (the scalar
    body at the main path's chunk, where the 6.45 MB calls take it; the
    streaming bodies at a chunk of 25), the s2d and subpixel pixel layer's
    on its body, and counts the wrapper by body on every path."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    n = 2 * chip_smoke.STEPS
    at8 = chip_smoke._true_route_launches(2, chip_smoke.STEPS)
    assert at8["fused_lstm_gates"] == 4 * n
    assert {k: v for k, v in at8.items() if k.startswith("fused_lstm_gates/")} == {
        "fused_lstm_gates/scalar": 2 * n, "fused_lstm_gates/vector": 2 * n}
    at25 = chip_smoke._true_route_launches(2, chip_smoke.STEPS, 25)
    assert {k: v for k, v in at25.items() if k.startswith("fused_lstm_gates/")} == {
        "fused_lstm_gates/slab": n, "fused_lstm_gates/vector": 3 * n}
    s2d = chip_smoke._path_launches(1, 4, "fused_lstm_gates", (3, 2), gate_body="slab")
    assert s2d["fused_lstm_gates"] == s2d["fused_lstm_gates/slab"] == 4
    assert chip_smoke._gate_body(16 * 60 * 80, 12) == "slab"
    assert chip_smoke._gate_body(8 * 60 * 80, 12) == "scalar"
    assert "fused_lstm_gates" in chip_smoke.BY_BODY
    assert all(chip_smoke.TRACE_KERNELS[f"fused_lstm_gates/{b}"][1] == 0 for b in ("vector", "slab"))
