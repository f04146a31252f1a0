"""The True route's gate convs on the CPU: the host plan of their two bodies
and a torch model of the wgmma body (``csrc/gate_convs_wgmma.cu``).

``ops/convlstm_narrow.py::gate_plan`` picks the body (the wgmma one in
bfloat16 compute at C >= 32 with sources the TMA can address, else the
mma.sync one) and the wgmma body's tile and channel group from the layer's
shape, channels and compute dtype, never from the batch.  The card cannot
be asked here, so these tests check the plan at the bundled stacks' layers,
its coverage of every output pixel and channel, R_above's coarse box, and
run a model of the body's walk — the halo slab as the TMA fills it, R_above's
coarse box expanded 2x as the block's threads expand it, each tap a shifted
run of slab rows, one float32 chain a source rounded to bfloat16 at the
source's end, the rounded adds — against the plain version and the rounded
float64 chain.  ``test_torch_cuda.py`` holds the kernel itself on a card.
Inputs are made by numpy from a seed.
"""

import numpy as np
import pytest
import torch

from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_narrow as cn
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import Plan, pack_gate_weight
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import lstm_gates_plain
from evolutionary_illusion_generator_tpu_torch.scripts import fused_breakdown as fb
from evolutionary_illusion_generator_tpu_torch.utils.profiling import by_wrapper

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
KC = 16  # input channels a chunk

# (H, W, C) of the bundled stacks' layers (3,48,96,192 and 1,16,32,64) at
# the main path's 160x120, the north star's 640x480 and the composition's
# 1280x960
STACKS = {"color": (3, 48, 96, 192), "gray": (1, 16, 32, 64)}
FRAMES = {"main": (120, 160), "north_star": (480, 640), "composition": (960, 1280)}
LAYERS = [(f"{stack} {frame} {l}", H >> l, W >> l, C)
          for stack, chans in STACKS.items() for frame, (H, W) in FRAMES.items()
          for l, C in enumerate(chans)]
# the colour stack's wgmma plans: (cg, tile_h, tile_w, wg_stride) by frame
COLOR_PLANS = {
    "main": {1: (16, 3, 40, 64), 2: (32, 3, 40, 64), 3: (32, 5, 20, 64)},
    "north_star": {1: (16, 2, 64, 66), 2: (32, 3, 40, 64), 3: (32, 3, 40, 64)},
}


@pytest.mark.parametrize("name,H,W,C", LAYERS)
def test_gate_plan_at_the_bundled_layers(name, H, W, C):
    """bfloat16 compute at C >= 32 takes the wgmma body at a tile of
    ``tile_shapes`` and a channel group of 48, 32 or 16; float32 compute and
    the narrow layers the mma.sync body at its strip width for one image;
    the colour stack's layers the groups of least measured cost
    (``GATE_GROUP_COST``: 16 at C 48, two blocks an SM; 32 at C 96 and 192,
    a ring of four)."""
    p = cn.gate_plan(H, W, C, BF16)
    assert cn.gate_plan(H, W, C, F32) == Plan("mma_sync", cn.gate_groups(C)[0] // 4, 0,
                                              cf.tile_width(1, H, W), 0)
    assert cn.gate_plan(H, W, C, BF16, tma=False).body == "mma_sync"
    if C < cn.GATE_WGMMA_MIN_C:
        assert p == cn.gate_plan(H, W, C, F32)
        return
    assert p.body == "wgmma" and p.cg in cf.CHANNEL_GROUPS
    assert (p.tile_h, p.tile_w, p.wg_stride) in cf.tile_shapes(W)
    stack, frame, layer = name.split()
    if stack == "color" and frame in COLOR_PLANS:
        assert tuple(p)[1:] == COLOR_PLANS[frame][int(layer)]


class _Library:
    """A stand-in for the kernels' library that records each gate-conv
    launch's body and plan arguments."""

    def __init__(self):
        self.calls = []

    def eigen_gate_convs_wgmma(self, *args):
        self.calls.append(("wgmma", args[-5:-1]))
        return 0

    def eigen_gate_convs(self, *args):
        self.calls.append(("mma_sync", args[-2:-1]))
        return 0


def _inputs(seed, B, H, W, C, C_above, cin_e=None):
    """Sources in [-1, 1] as a rollout's are (E of ``cin_e`` channels, 2C by
    default), weights at init_params' scale, a bfloat16 bias."""
    rng = np.random.default_rng(seed)
    cins = [cin_e or 2 * C, C] + ([C_above] if C_above else [])
    shapes = [(B, H, W, cins[0]), (B, H, W, C)] + ([(B, H // 2, W // 2, C_above)] if C_above
                                                   else [])
    srcs = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).bfloat16() for s in shapes]
    wks = [pack_gate_weight(torch.from_numpy(
        rng.normal(0, 1 / np.sqrt(9 * sum(cins)), (3, 3, ci, 4 * C)).astype(np.float32)))
        for ci in cins]
    b = torch.from_numpy(rng.normal(0, 0.3, 4 * C).astype(np.float32)).bfloat16()
    return srcs, wks, b


@pytest.mark.parametrize("H,W,C,C_above", [(60, 80, 48, 96), (30, 40, 96, 192), (15, 20, 192, None),
                                           (120, 160, 3, 48), (16, 24, 40, 12)])
def test_launch_takes_one_plan_whatever_the_batch(H, W, C, C_above, monkeypatch):
    """The launch's body and plan arguments are the same for a batch of 1,
    3, 8 and 25 (a shard of a batch takes the plan of the whole); R_above
    of 12 channels (rows of 24 bytes, which the TMA cannot address) takes
    the mma.sync body, as does a pixel layer."""
    lib = _Library()
    monkeypatch.setattr(cn._build, "library", lambda: lib)
    for B in (1, 3, 8, 25):
        srcs, wks, b = _inputs(B, B, H, W, C, C_above)
        gates = cn.launch_gates(srcs, wks, b, BF16, 0)
        assert gates.shape == (B, H, W, 4 * C) and gates.dtype == BF16
    assert len(set(lib.calls)) == 1
    body, args = lib.calls[0]
    p = cn.gate_plan(H, W, C, BF16, tma=C_above != 12)
    assert body == p.body == ("wgmma" if C >= 32 and C_above != 12 else "mma_sync")
    assert args == ((p.cg, p.tile_h, p.tile_w, p.wg_stride) if body == "wgmma" else (p.tile_w,))


def test_launch_refuses_a_wgmma_plan_the_body_cannot_take(monkeypatch):
    monkeypatch.setattr(cn._build, "library", _Library)
    srcs, wks, b = _inputs(1, 2, 8, 12, 40, 12)
    wg = Plan("wgmma", 48, 3, 10, 64)
    for cd, s in ((BF16, srcs), (F32, srcs[:2])):  # R_above of 12 channels; float32
        with pytest.raises(ValueError, match="wgmma body does not take"):
            cn.launch_gates(s, wks[:len(s)], b, cd, 0, plan=wg)
    with pytest.raises(ValueError, match="strip width"):
        cn.launch_gates(srcs, wks, b, BF16, 0, plan=Plan("mma_sync", 32, 0, 13, 0))


@pytest.mark.parametrize("name,H,W,C", [layer for layer in LAYERS if layer[3] >= 32])
def test_gate_plan_covers_every_pixel_and_channel_once(name, H, W, C):
    """The wgmma plan's blocks (``block_origins``, ``block_rows``) write
    every output pixel of a batch of 2 once, every channel in one group."""
    p = cn.gate_plan(H, W, C)
    pos, r, col, computed = cf.block_rows(p)
    org = cf.block_origins(p, 2, H, W)
    y, x = org[:, 1:2] + r, org[:, 2:3] + col
    written = computed & (y < H) & (x < W)
    b = org[:, 0:1].expand_as(y)
    counts = torch.zeros(2 * H * W, dtype=torch.int32)
    counts.index_add_(0, ((b * H + y) * W + x)[written],
                      torch.ones(int(written.sum()), dtype=torch.int32))
    assert torch.equal(counts, torch.ones_like(counts))
    groups = [range(g * p.cg, min((g + 1) * p.cg, C)) for g in range(-(-C // p.cg))]
    assert [c for g in groups for c in g] == list(range(C))


@pytest.mark.parametrize("W", [2, 3, 10, 20, 40, 62, 64, 80, 130, 320])
def test_coarse_box_holds_every_tile_and_parity(W):
    """R_above's box (:func:`convlstm_narrow.coarse_box`) fits the kernel's
    COARSE_PIXELS at every tile of ``tile_shapes``, and the expansion's
    coarse row and column of every slab position lie inside it whatever the
    parity of the tile's origin (tile_h and tile_w may be odd); the slab
    positions the warpgroups read stay inside a stage's SLAB_PIXELS."""
    for th, tw, ws in cf.tile_shapes(W):
        ch, cw = cn.coarse_box(th, tw)
        assert ch * cw <= cn.COARSE_PIXELS
        assert ws + cf.WG_ROWS - 1 + 2 * (tw + 2) + 2 < cf.SLAB_PIXELS
        r = torch.arange(th + 2)
        col = torch.arange(tw + 2)
        for y0 in range(4):
            cr = ((y0 - 1 + r) >> 1) - ((y0 - 1) >> 1)
            assert int(cr.min()) == 0 and int(cr.max()) < ch
        for x0 in range(4):
            cc = ((x0 - 1 + col) >> 1) - ((x0 - 1) >> 1)
            assert int(cc.min()) == 0 and int(cc.max()) < cw


# ---------------------------------------------------------------------------
# the model of the wgmma body


def emulate(srcs, wks, b, p: Plan):
    """A torch model of ``csrc/gate_convs_wgmma.cu`` at plan ``p``: per
    channel group and tile, per source, per chunk of 16 channels, the halo
    slab as the TMA fills it (zeros outside the image and past cin; NaN past
    the box, where only rows that are not output pixels read); R_above's
    as its coarse box (rows ``(y0 - 1) >> 1`` .., :func:`coarse_box`) with
    slab position (r, col) taken from coarse pixel ``((y0 - 1 + r) >> 1,
    (x0 - 1 + col) >> 1)`` of it; each tap's M rows at slab position
    ``block_rows + ky * slab_w + kx``; every product of the source (chunk,
    then tap, each tap's 16 products summed exactly) added into one float32
    sum; that sum rounded to bfloat16 and added to the running gates (the
    bias rounded to bfloat16 first), the add rounded to bfloat16.  Returns
    the gates as the kernel writes them, gate-major, NaN where it writes
    nothing."""
    B, H, W, C = srcs[1].shape
    sw, th, tw = p.tile_w + 2, p.tile_h, p.tile_w
    pos, r, col, computed = cf.block_rows(p)
    org = cf.block_origins(p, B, H, W)
    out = torch.full((B, H, W, 4 * C), float("nan"))
    ty, tx = -(-H // th), -(-W // tw)
    iy = org[:, 1:2] - 1 + torch.arange(th + 2)  # (tiles, th + 2) image rows
    ix = org[:, 2:3] - 1 + torch.arange(sw)      # (tiles, slab_w) image columns
    ch, cw = cn.coarse_box(th, tw)
    for c0 in range(0, C, p.cg):
        N, n_c = 4 * p.cg, min(p.cg, C - c0)
        bias = torch.zeros(p.cg, 4)
        bias[:n_c] = b.float().reshape(4, C)[:, c0:c0 + n_c].t()
        gates = bias.reshape(1, 1, N).bfloat16().float().expand(len(org), 2 * cf.WG_ROWS, N)
        for s, (x, wk) in enumerate(zip(srcs, wks)):
            cin = x.shape[-1]
            coarse = s == 2
            # zero padding: one pixel around, and far enough past the last tile
            Hs, Ws = (H // 2, W // 2) if coarse else (H, W)
            xp = torch.zeros(B + 1, Hs + th + 4, Ws + tw + 4, -(-cin // KC) * KC)
            xp[:B, 1:Hs + 1, 1:Ws + 1, :cin] = x.float()
            wt = torch.zeros(9, p.cg, 4, xp.shape[-1])
            wt[:, :n_c, :, :cin] = wk[:, c0:c0 + n_c].float()
            wt = wt.reshape(9, N, -1).double()
            acc = torch.zeros(len(org), 2 * cf.WG_ROWS, N)
            for k0 in range(0, cin, KC):
                if coarse:  # the box, then the expansion
                    cy = ((org[:, 1:2] - 1) >> 1) + torch.arange(ch)
                    cx = ((org[:, 2:3] - 1) >> 1) + torch.arange(cw)
                    box = xp[org[:, 0, None, None], cy[:, :, None] + 1, cx[:, None, :] + 1,
                             k0:k0 + KC]  # (tiles, ch, cw, 16)
                    rr = ((iy >> 1) - ((org[:, 1:2] - 1) >> 1))[:, :, None]
                    cc = ((ix >> 1) - ((org[:, 2:3] - 1) >> 1))[:, None, :]
                    slab = box[torch.arange(len(org))[:, None, None], rr, cc]
                else:
                    slab = xp[org[:, 0, None, None], iy[:, :, None] + 1, ix[:, None, :] + 1,
                              k0:k0 + KC]  # (tiles, th + 2, slab_w, 16)
                flat = torch.full((len(org), cf.SLAB_PIXELS, KC), float("nan"))
                flat[:, :(th + 2) * sw] = slab.reshape(len(org), -1, KC)
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    a = flat[:, pos + ky * sw + kx].double()  # (tiles, 128, 16)
                    acc = (acc.double() + a @ wt[tap, :, k0:k0 + KC].T).float()
            gates = (gates + acc.bfloat16().float()).bfloat16().float()
        y, xx = org[:, 1:2] + r, org[:, 2:3] + col
        ok = computed & (y < H) & (xx < W)
        bb = org[:, 0:1].expand_as(y)
        g = gates[ok].reshape(-1, p.cg, 4)[:, :n_c]  # (pixels, channels, gate)
        for gate in range(4):
            out[bb[ok], y[ok], xx[ok], gate * C + c0:gate * C + c0 + n_c] = g[..., gate]
    return out.bfloat16()


# The model and the plain version (oneDNN's float32 convs, rounded) sum
# each source in another order: where a sum lies at a bfloat16 rounding
# boundary they round it apart, one ulp at that point.  Held: both within
# one ulp at each rounding point of the rounded float64 chain, their gates
# apart on at most MODEL_DIFF_SHARE of the elements, and h and c through
# the gate math within ``chain_float64``'s bounds.
MODEL_DIFF_SHARE = 0.01

# (B, H, W, C, C_above, E's channels, plan or None for gate_plan's): the
# layers' kinds at small widths, with ragged and odd tiles
EMULATED = {
    "layer1": (2, 12, 16, 48, 96, None, None),
    "top": (2, 10, 12, 64, None, None, None),
    "ragged_group": (2, 8, 12, 40, 16, None, None),
    "odd_tiles": (2, 14, 22, 32, 24, 40, Plan("wgmma", 32, 5, 7, 64)),
    "two_rows": (1, 6, 70, 32, 16, None, Plan("wgmma", 16, 2, 64, 66)),
    "cg48_run_on": (3, 10, 18, 48, 16, None, Plan("wgmma", 48, 3, 13, 64)),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_body_against_the_plain_version_and_the_chain(case):
    B, H, W, C, C_above, cin_e, p = EMULATED[case]
    srcs, wks, b = _inputs(C + H, B, H, W, C, C_above, cin_e)
    p = p or cn.gate_plan(H, W, C)
    assert p.body == "wgmma"
    got = emulate(srcs, wks, b, p)
    assert not bool(torch.isnan(got.float()).any())  # every gate written
    plain = cn.gate_convs_plain(srcs, wks, b, compute_dtype=BF16)
    g, err, _ = cn.gate_chain_float64(srcs, wks, b)
    for name, t in (("model", got), ("plain", plain)):
        assert bool(((t.double() - g).abs() <= err).all()), name
    assert (got != plain).float().mean().item() <= MODEL_DIFF_SHARE
    # through the gate math: h and c within one ulp at each rounding point
    c_prev = torch.from_numpy(np.random.default_rng(C).normal(0, 1, (B, H, W, C))
                              .astype(np.float32)).bfloat16()
    chain = cn.chain_float64(srcs, wks, b, c_prev)
    h, c = lstm_gates_plain(got, c_prev, out_dtype=BF16)
    assert bool(((h.double() - chain["h"]).abs() <= chain["dh"]).all())
    assert bool(((c.double() - chain["c"]).abs() <= chain["dc"]).all())


def test_emulated_rows_follow_no_batch_tile_or_group():
    """The model sums a pixel in one order whatever the batch, the tile or
    the channel group: rows 1..2 of a batch of 3 alone, and the whole batch
    at every channel group and other tiles, bit-equal to the plan's."""
    B, H, W, C, C_above = 3, 10, 14, 48, 24
    srcs, wks, b = _inputs(5, B, H, W, C, C_above)
    want = emulate(srcs, wks, b, cn.gate_plan(H, W, C))
    part = [x[1:3] for x in srcs]
    assert torch.equal(emulate(part, wks, b, cn.gate_plan(H, W, C)), want[1:3])
    for cg in cf.CHANNEL_GROUPS:
        for th, tw, ws in (cf.tile_shapes(W)[0], cf.tile_shapes(W)[3], cf.tile_shapes(W)[-1]):
            assert torch.equal(emulate(srcs, wks, b, Plan("wgmma", cg, th, tw, ws)), want)


def test_traces_name_the_wgmma_gate_convs():
    """The profile's wrappers: the wgmma body's kernel counts for
    ``gate_convs`` beside the mma.sync body's, neither as a library conv."""
    events = [("void (anonymous namespace)::gate_convs_wgmma_kernel<192>(CUtensorMap, "
               "CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
               "__nv_bfloat16*, (anonymous namespace)::Geometry)", 66, 3e3),
              ("void (anonymous namespace)::gate_convs_kernel<16, __nv_bfloat16>(Params, "
               "__nv_bfloat16*)", 22, 1e3)]
    got = by_wrapper(events)
    assert got["gate_convs"] == {"count": 88, "ms": 4.0}
    assert got["library convs"]["count"] == 0


@pytest.mark.parametrize("name", list(fb.GATE_VARIANTS))
def test_gate_breakdown_variants_apply(name):
    """Each timing variant of the gates-out body still finds its text in
    csrc/gate_convs_wgmma.cu once (the script raises otherwise), all but the
    kernel itself change it, and the entry stays."""
    variant = fb.gate_variant_source(name)
    assert (variant == fb._GATE_SOURCE.read_text()) == (name == "kernel")
    assert 'extern "C" int eigen_gate_convs_wgmma(' in variant


def test_rollout_profile_takes_the_true_route(monkeypatch, capsys):
    """``scripts/rollout_profile.py --use_pallas true`` rolls out on the
    ``use_pallas=True`` route (its gate convs called on every layer) and
    says so in its JSON line; the default line is as it was."""
    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.scripts import rollout_profile

    tiny = ["--pop", "2", "--width", "32", "--height", "24", "--channels", "3,4,8",
            "--device", "cpu", "--repeat", "2", "--s2d", "0"]
    calls = []
    gate_convs = model.gate_convs

    def spy(srcs, wks, b, **kw):
        calls.append(srcs[1].shape[-1])
        return gate_convs(srcs, wks, b, **kw)

    monkeypatch.setattr(model, "gate_convs", spy)
    default = rollout_profile.main(tiny)
    assert "use_pallas" not in default and not calls
    got = rollout_profile.main(tiny + ["--use_pallas", "true"])
    assert got["use_pallas"] == "true"
    # three layers a step, 2 + 2 steps a rollout, five rollouts (the first,
    # three timed, one profiled)
    assert calls[:3] == [8, 4, 3] and len(calls) == 3 * 4 * 5
    capsys.readouterr()


def test_chip_smoke_counts_the_true_route_by_body():
    """``chip_smoke.py`` expects the True route's gate convs by body: the
    three wide layers of 3,48,96,192 on the wgmma body, the pixel layer on
    the mma.sync body, and counts the wrapper by body on every path."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    want = chip_smoke._true_route_launches(2, chip_smoke.STEPS)
    n = 2 * chip_smoke.STEPS
    assert want["gate_convs"] == 4 * n and want["fused_lstm_gates"] == 4 * n
    assert want["gate_convs/wgmma"] == 3 * n and want["gate_convs/mma_sync"] == n
    assert "gate_convs" in chip_smoke.BY_BODY
    assert chip_smoke.TRACE_KERNELS["gate_convs/wgmma"] == ("gate_convs_wgmma_kernel", 0)
