"""K9, the weight gradient of block 1's VALID 3³ tile convolution, and the
route that takes it (``ops/conv3d.py``, ``csrc/conv3d_wgrad.cu``), without
JAX.

On the CPU: the plain version against autograd of ``F.conv3d`` in float64;
the kernel emulated in numpy — its units and ring slots (dy swizzled, x as
it is and one site on), ``ldmatrix.trans`` as each lane addresses it, the
``mma.m16n8k16`` fragments, the split over blocks and the fixed-order
reduction — against the plain version; the work count; which convs K9
takes (``has_wgrad_form``, ``takes_kernel_wgrad``) and ``ConvBlock``'s
routing; a windowed_compact step's gradients with and without the route.
On a card (``-m cuda``): the kernel against a float64 sum at the main
path's row counts and past 2^31 dy elements, no worse than cuDNN's own
error; launch to launch the same; the zero pad channel exactly 0; the
wrapper's refusals; one launch a compact bf16 train step at ``ef_dim`` 32
and none at 8 or 16. Run the card tests with

    python -m pytest --noconftest tests/test_torch_conv3d_wgrad.py -m cuda
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from tricolo_tpu_torch.ops.conv3d import (  # noqa: E402
    FORMS,
    WGRAD_FORMS,
    conv3d_valid_kernel_wgrad,
    conv3d_valid_wgrad,
    conv3d_valid_wgrad_plain,
    has_wgrad_form,
    takes_kernel_wgrad,
    work,
)

HALO3, HALO1 = WGRAD_FORMS


def _inputs(rows, size, seed, dtype=torch.float32, device="cpu", pad_channel=False):
    """dy (R, 32, S−2, S−2, S−2) and x (R, 4, S, S, S), each the channels-last
    view of an NDHWC tensor (as autograd hands them to the backward); with
    ``pad_channel`` x's fourth channel is 0, as block 1's input is."""
    d = size - 2
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, size, size, size, 4), generator=g)
    if pad_channel:
        x[..., 3] = 0
    dy = torch.randn((rows, d, d, d, 32), generator=g)
    return (dy.to(dtype).to(device).permute(0, 4, 1, 2, 3),
            x.to(dtype).to(device).permute(0, 4, 1, 2, 3))


@pytest.mark.parametrize("shape,rows", [(HALO3, 1), (HALO3, 3), (HALO1, 2), (HALO1, 5)])
def test_plain_is_autograds_weight_gradient(shape, rows):
    """float64: ``convolution_backward`` for the weight alone is the weight
    gradient autograd takes through ``F.conv3d``."""
    size = shape[0]
    dy, x = _inputs(rows, size, rows, torch.float64)
    w = torch.randn((32, 4, 3, 3, 3), dtype=torch.float64, requires_grad=True)
    F.conv3d(x, w).backward(dy)
    got = conv3d_valid_wgrad_plain(dy, x)
    assert got.shape == (32, 4, 3, 3, 3) and got.dtype == torch.float64
    assert torch.allclose(got, w.grad, rtol=0, atol=1e-12 * w.grad.abs().max().item())


@pytest.mark.parametrize("shape,rows", [(HALO3, 1), (HALO1, 3)])
def test_kernel_wgrad_conv_matches_autograd(shape, rows):
    """The convolution whose backward takes K9 (on the CPU, its plain
    version): forward and weight gradient equal ``F.conv3d``'s, and the
    input gradient is autograd's where the input needs one."""
    size = shape[0]
    dy, x = _inputs(rows, size, rows + 10)
    w = torch.randn((32, 4, 3, 3, 3)) / math.sqrt(27 * 4)
    got_x, got_w = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref_x, ref_w = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = conv3d_valid_kernel_wgrad(got_x, got_w)
    ref = F.conv3d(ref_x, ref_w)
    assert torch.allclose(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())
    got.backward(dy)
    ref.backward(dy)
    for a, b in ((got_x.grad, ref_x.grad), (got_w.grad, ref_w.grad)):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


# ------------------------------------------------- the kernel's layout, emulated


def _form(size):
    """``csrc/conv3d_wgrad.cu``'s ``Form<S, Z>`` constants (bytes)."""
    d = size - 2
    z = 4 if size == 14 else 8
    f = dict(S=size, Z=z, D=d, PLANE=d * d, CHUNKS=d // z, KSTEPS=z * d * d // 16,
             XSITES=(z + 2) * size * size)
    f["DYB"] = z * d * d * 64
    f["XB"] = f["XSITES"] * 8
    f["E_AT"] = f["DYB"]
    f["O_AT"] = f["DYB"] + (f["XB"] + 127) // 128 * 128 + 48
    f["SLOT"] = (f["O_AT"] + f["XB"] + 16 + 127) // 128 * 128
    return f


def _ldmatrix_trans(slot, addresses):
    """``ldmatrix.m8n8.x4.trans`` on ``slot`` (2-byte elements): lane l
    names row l % 8 of matrix l // 8 by its byte address; lane i gets, in
    register j, elements [2(i % 4)][i // 4] and [2(i % 4) + 1][i // 4] of
    matrix j as stored; every row address 16-byte aligned, as the
    instruction requires. Returns (32 lanes, 4 registers, 2)."""
    assert (addresses % 16 == 0).all()
    rows = slot[(addresses // 2)[:, None] + np.arange(8)].reshape(4, 8, 8)
    lane = np.arange(32)
    return np.stack([np.stack([rows[j, 2 * (lane % 4) + e, lane // 4] for e in (0, 1)], -1)
                     for j in range(4)], 1)


_LANE = np.arange(32)
_G, _T = _LANE // 4, _LANE % 4


def _a_matrix(regs):
    """The 16 × 16 A of ``mma.m16n8k16`` from its lanes' registers: a0a1
    (g, 2t), a2a3 (g + 8, 2t), a4a5 (g, 2t + 8), a6a7 (g + 8, 2t + 8)."""
    a = np.zeros((16, 16))
    for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for e in (0, 1):
            a[_G + dm, 2 * _T + dk + e] = regs[:, r, e]
    return a


def _b_matrix(r0, r1):
    """The 16 × 8 B (k × n): b0b1 at k = 2t, 2t + 1 and b2b3 at k = 2t + 8,
    2t + 9, column n = g."""
    b = np.zeros((16, 8))
    for e in (0, 1):
        b[2 * _T + e, _G] = r0[:, e]
        b[2 * _T + 8 + e, _G] = r1[:, e]
    return b


def _output_index():
    """(row o, column of the 32 × 144 tile) → dw index, for the columns the
    kernel keeps: tile nt = 2·(tz, ty) + j, column n → tap tx = 2j + n // 4
    (3: junk), input channel n % 4."""
    o, col, out = [], [], []
    for nt in range(18):
        for n in range(8):
            tx = 2 * (nt & 1) + (n >> 2)
            if tx == 3:
                continue
            tap = 3 * (nt >> 1) + tx
            for oo in range(32):
                o.append(oo)
                col.append(8 * nt + n)
                out.append((oo * 4 + (n & 3)) * 27 + tap)
    return np.array(o), np.array(col), np.array(out)


def _emulate(dy, x, blocks):
    """dw (32, 4, 3, 3, 3) as ``csrc/conv3d_wgrad.cu`` computes it on a grid
    of ``blocks`` blocks, its indexing step by step, in float64. Shared
    memory a unit does not write is NaN (but the zeroed junk word), so a
    kept output that read it is NaN."""
    f = _form(x.shape[2])
    S, D, PLANE, Z = f["S"], f["D"], f["PLANE"], f["Z"]
    rows = x.shape[0]
    dyn = dy.permute(0, 2, 3, 4, 1).reshape(rows, -1).double().numpy()
    xn = x.permute(0, 2, 3, 4, 1).reshape(rows, -1).double().numpy()
    units = rows * f["CHUNKS"]
    grid = min(blocks, units)
    o_idx, col_idx, out_idx = _output_index()
    pieces = np.arange(f["DYB"] // 16)
    q, c = pieces >> 2, pieces & 3
    dy_dst = (q * 64 + ((c ^ ((q >> 1) & 3)) << 4)) // 2
    partial = np.zeros((grid, 3456))
    for b in range(grid):
        first, end = units * b // grid, units * (b + 1) // grid
        tiles = np.zeros((8, 32, 144))  # each warp's 32 × 144 accumulator tile
        for u in range(first, end):
            row, chunk = divmod(u, f["CHUNKS"])
            slot = np.full(f["SLOT"] // 2, np.nan)
            junk = (f["O_AT"] + 8 + 8 * f["XSITES"]) // 2
            slot[junk:junk + 4] = 0.0
            src = dyn[row, chunk * f["DYB"] // 2:(chunk + 1) * f["DYB"] // 2].reshape(-1, 8)
            slot[dy_dst[:, None] + np.arange(8)] = src
            xs = xn[row, chunk * Z * S * S * 4:][:f["XB"] // 2]
            slot[f["E_AT"] // 2:f["E_AT"] // 2 + xs.size] = xs
            slot[(f["O_AT"] + 8) // 2:(f["O_AT"] + 8) // 2 + xs.size] = xs
            for warp in range(8):
                for ks in range(warp, f["KSTEPS"], 8):
                    qa = 16 * ks + (_LANE & 7) + 8 * (_LANE >> 4)
                    ca = (_LANE >> 3) & 1
                    swz = (qa >> 1) & 3
                    a = np.concatenate([_a_matrix(_ldmatrix_trans(
                        slot, qa * 64 + (((2 * mt + ca) ^ swz) << 4))) for mt in (0, 1)])
                    p = 16 * ks + (_LANE & 7) + 8 * ((_LANE >> 3) & 1)
                    pz, pr = p // PLANE, p % PLANE
                    py, px = pr // D, pr % D
                    site = (pz * S + py) * S + px
                    xrow = (np.where(px & 1, f["O_AT"] + 8, f["E_AT"]) + 8 * site
                            + 16 * (_LANE >> 4))
                    bs = []
                    for i in range(9):
                        regs = _ldmatrix_trans(slot, xrow + 8 * ((i // 3) * S * S + (i % 3) * S))
                        bs += [_b_matrix(regs[:, 0], regs[:, 1]),
                               _b_matrix(regs[:, 2], regs[:, 3])]
                    tiles[warp] += a @ np.concatenate(bs, 1)
        red = np.zeros((8, 3456))
        red[:, out_idx] = tiles[:, o_idx, col_idx]
        for warp in range(8):  # the block's partial, in warp order
            partial[b] += red[warp]
    dw = np.zeros(3456)
    for b in range(grid):  # the reduce pass, in block order
        dw += partial[b]
    return torch.from_numpy(dw).reshape(32, 4, 3, 3, 3)


@pytest.mark.parametrize("shape,rows,blocks", [
    (HALO3, 1, 132), (HALO3, 3, 132), (HALO3, 7, 132), (HALO3, 11, 4),
    (HALO1, 1, 132), (HALO1, 3, 132), (HALO1, 7, 132), (HALO1, 11, 4),
])
def test_emulated_kernel_matches_plain(shape, rows, blocks):
    """The kernel's units, ring layout (dy swizzle, x as it is and one site
    on), ldmatrix lane roles, fragments, junk tap, warp and block split and
    its reductions, emulated in float64, give the plain weight gradient; 11
    rows on 4 blocks is an odd count past a block's share (units split
    mid-row at the 14³ form)."""
    dy, x = _inputs(rows, shape[0], 100 + rows, torch.float64)
    got = _emulate(dy, x, blocks)
    ref = conv3d_valid_wgrad_plain(dy, x)
    assert not torch.isnan(got).any()
    assert torch.allclose(got, ref, rtol=0, atol=1e-12 * ref.abs().max().item())


def test_emulated_kernel_keeps_the_zero_pad_channel_zero():
    dy, x = _inputs(2, HALO3[0], 3, torch.float64, pad_channel=True)
    got = _emulate(dy, x, 132)
    assert torch.equal(got[:, 3], torch.zeros_like(got[:, 3]))
    assert got[:, :3].abs().min() > 0


def test_work_is_the_true_work():
    """At train_spread's 17,536 rows: dy 110,592 and x 21,952 bytes a row
    read, the 3,456 weights written once (2.32 GB: 0.694 ms at 3.35 TB/s);
    2·27·4·32 = 6,912 FLOPs a position. The 10³ form likewise."""
    nbytes, flops = work(17_536, *HALO3)
    assert nbytes == 17_536 * (110_592 + 21_952) + 3_456 * 2 == 2_324_298_496
    assert flops == 17_536 * 12**3 * 6_912
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.6938, abs=1e-4)
    nbytes, flops = work(1_000, *HALO1)
    assert nbytes == 1_000 * (8**3 * 32 + 10**3 * 4) * 2 + 6_912
    assert flops == 1_000 * 8**3 * 6_912


def test_work_counter_classes_k9_as_bf16():
    from tricolo_tpu_torch import ops, work as _work

    assert _work.LABELS["conv3d_valid_wgrad"] == "K9"
    assert ops.conv3d_valid_wgrad in ops.KERNELS and len(ops.launches()) == 14
    counter = _work.WorkCounter()
    with counter.kernel("K9", work, (128, *HALO3)):
        pass
    assert counter.records[0][:3] == [0, "K9", "bf16"]
    assert counter.kernel_args[0][0] == "tricolo_tpu_torch.ops.conv3d"


@pytest.mark.parametrize("shape", WGRAD_FORMS)
def test_cpu_tensors_take_the_plain_version(shape):
    from tricolo_tpu_torch import ops

    ops.reset_launches()
    dy, x = _inputs(3, shape[0], 1)
    assert torch.equal(conv3d_valid_wgrad(dy, x), conv3d_valid_wgrad_plain(dy, x))
    assert ops.launches()["conv3d_valid_wgrad"] == 0


def test_the_two_kernels_forms_are_disjoint():
    """No convolution needs both K8 and K9: ``ConvBlock`` asks K8 first."""
    assert not set(FORMS) & set(WGRAD_FORMS)


@pytest.mark.parametrize("dtype,x_shape,w_shape,want", [
    (torch.bfloat16, (7, 4, 14, 14, 14), (32, 4, 3, 3, 3), True),  # block 1, halo 3
    (torch.bfloat16, (7, 4, 10, 10, 10), (32, 4, 3, 3, 3), True),  # halo 1, dense plan
    (torch.float32, (7, 4, 14, 14, 14), (32, 4, 3, 3, 3), False),  # an f32-compute step
    (torch.float16, (7, 4, 14, 14, 14), (32, 4, 3, 3, 3), False),
    (torch.bfloat16, (7, 4, 14, 14, 14), (8, 4, 3, 3, 3), False),  # ef_dim 8
    (torch.bfloat16, (7, 4, 14, 14, 14), (16, 4, 3, 3, 3), False),  # ef_dim 16
    (torch.bfloat16, (7, 4, 14, 14, 14), (64, 4, 3, 3, 3), False),  # ef_dim 64
    (torch.bfloat16, (7, 4, 12, 12, 12), (32, 4, 3, 3, 3), False),  # another window
    (torch.bfloat16, (7, 32, 6, 6, 6), (64, 32, 3, 3, 3), False),  # block 2: K8's
    (torch.bfloat16, (7, 3, 14, 14, 14), (32, 3, 3, 3, 3), False),  # no pad channel
    (torch.bfloat16, (7, 4, 14, 14, 14), (32, 4, 1, 1, 1), False),  # not 3³ taps
    (torch.bfloat16, (7, 4, 14, 14, 12), (32, 4, 3, 3, 3), False),  # not cubic
])
def test_has_wgrad_form(dtype, x_shape, w_shape, want):
    """K9 takes a conv's weight gradient in bf16 at the forms of
    ``WGRAD_FORMS`` alone, so no width the ``ef_dim`` key allows reaches
    its refusal."""
    assert has_wgrad_form(dtype, x_shape, w_shape) is want


@pytest.mark.parametrize("x_grad", [False, True])
@pytest.mark.parametrize("w_grad", [False, True])
@pytest.mark.parametrize("dtype,autocast", [(torch.float32, False), (torch.bfloat16, False),
                                            (torch.float32, True)])
@pytest.mark.parametrize("shape", WGRAD_FORMS)
def test_takes_kernel_wgrad_never_on_the_cpu(shape, dtype, autocast, w_grad, x_grad):
    """The CPU keeps ``F.conv3d``'s one backward, whatever the form, dtype
    and gradients."""
    size = shape[0]
    x = torch.zeros(2, 4, size, size, size, dtype=dtype, requires_grad=x_grad)
    w = torch.zeros(32, 4, 3, 3, 3, dtype=dtype, requires_grad=w_grad)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        assert not takes_kernel_wgrad(x, w)


def _as_on_the_card(x, w):
    """``takes_kernel_wgrad`` as a bf16 step on the card decides it."""
    return w.requires_grad and torch.is_grad_enabled() and has_wgrad_form(torch.bfloat16,
                                                                          x.shape, w.shape)


@pytest.mark.parametrize("case", ["block1", "block1_x_grad", "block1_no_grad", "block1_frozen",
                                  "block1_halo1", "block2", "explicit", "plain_path",
                                  "other_width", "cpu"])
def test_conv_block_routes_block1_to_the_wgrad_kernel(monkeypatch, case):
    """With the card's decision standing in for the device: block 1's VALID
    conv takes the K9 route whether or not its input needs a gradient, and
    only while its weight needs one; block 2 keeps the K8 route (cuDNN's
    weight gradient); ``explicit_dgrad`` and the plain path take neither;
    on the CPU (``cpu``: the real decision) none is taken."""
    from tricolo_tpu_torch.models import voxel_cnn
    from tricolo_tpu_torch.ops import conv3d as conv_ops

    if case != "cpu":
        monkeypatch.setattr(voxel_cnn, "takes_kernel_wgrad", _as_on_the_card)
        monkeypatch.setattr(voxel_cnn, "takes_kernel_dgrad",
                            lambda x, w: x.requires_grad and torch.is_grad_enabled()
                            and conv_ops.has_form(torch.bfloat16, x.shape, w.shape))
    calls = []
    for name in ("conv3d_valid_kernel_wgrad", "conv3d_valid_kernel_dgrad",
                 "conv3d_valid_explicit_dgrad"):
        real = getattr(voxel_cnn, name)
        monkeypatch.setattr(voxel_cnn, name,
                            lambda x, w, _real=real, _name=name: calls.append(_name) or _real(x, w))
    wgrads = []
    monkeypatch.setattr(conv_ops, "_kernel_wgrad",
                        lambda dy, x, w: wgrads.append(x.shape) or conv_ops.conv3d_valid_wgrad(
                            dy, x))
    cin, size = {"block2": (32, 6), "other_width": (4, 14), "block1_halo1": (4, 10)}.get(
        case, (4, 14))
    cout = {"block2": 64, "other_width": 16}.get(case, 32)
    block = voxel_cnn.ConvBlock(cin, cout).train()
    if case == "block1_frozen":
        block.conv.weight.requires_grad_(False)
    x = torch.randn(2, size, size, size, cin)
    mask = torch.ones(2, size - 2, size - 2, size - 2, 1)
    kwargs = {"explicit_dgrad": case == "explicit", "use_kernels": case != "plain_path"}
    if case in ("block1_x_grad", "block2"):
        x.requires_grad_()
    if case == "block1_no_grad":
        with torch.no_grad():
            block(x, mask, **kwargs)
    else:
        out, _ = block(x, mask, **kwargs)
        out.float().sum().backward()
        if x.requires_grad:
            assert x.grad is not None and x.grad.shape == x.shape
        if case != "block1_frozen":
            assert block.conv.weight.grad is not None
    want = {"block1": ["conv3d_valid_kernel_wgrad"],
            "block1_x_grad": ["conv3d_valid_kernel_wgrad"],
            "block1_halo1": ["conv3d_valid_kernel_wgrad"],
            "block2": ["conv3d_valid_kernel_dgrad"],
            "explicit": ["conv3d_valid_explicit_dgrad"]}.get(case, [])
    assert calls == want
    assert len(wgrads) == (1 if want == ["conv3d_valid_kernel_wgrad"] else 0)


def test_compact_step_gradients_unchanged_by_the_route(monkeypatch):
    """A windowed_compact train step of the voxel encoder (ef_dim 32, f32 on
    the CPU): every parameter's gradient through the K9 route (taken on the
    CPU as on the card, K9's plain version in its place) equals the plain
    path's (autograd's convolution backward) within f32 noise, and the route
    was taken by block 1 alone, once."""
    from tricolo_tpu_torch.models import voxel_cnn

    routed = []
    monkeypatch.setattr(voxel_cnn, "takes_kernel_wgrad",
                        lambda x, w: routed.append(_as_on_the_card(x, w)) or routed[-1])
    torch.manual_seed(0)
    enc = voxel_cnn.VoxelCNNEncoder(ef_dim=32, z_dim=32, out_dim=16).train()
    batch, k = 2, 3
    g = torch.Generator().manual_seed(1)
    rgb = torch.randint(0, 2**24, (batch, k, 14**3), generator=g, dtype=torch.int32)
    occ = (torch.rand((batch, k, 14**3), generator=g) < 0.4).to(torch.int32) << 24
    rows = rgb | occ
    ids = torch.stack([torch.randperm(512, generator=g)[:k] for _ in range(batch)]).int()
    grads = []
    for use_kernels in (True, False):
        enc.zero_grad()
        enc.use_kernels = use_kernels
        out = enc(rows, ids)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append({n: p.grad.clone() for n, p in enc.named_parameters()})
    assert routed == [True, False]  # block 1 yes, block 2 no, in the use_kernels pass
    for name, ref in grads[1].items():
        assert (grads[0][name] - ref).abs().max() <= 1e-5 * ref.abs().max(), name


# ---------------------------------------------------------------- card


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K9 has no CPU mode")


def _launches() -> int:
    from tricolo_tpu_torch import ops

    return ops.launches()["conv3d_valid_wgrad"]


def _card_inputs(rows, size, seed, pad_channel=False):
    d = size - 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, size, size, size, 4), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    if pad_channel:
        x[..., 3] = 0
    dy = torch.randn((rows, d, d, d, 32), generator=gen, device="cuda", dtype=torch.bfloat16)
    return dy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3)


def _exact(dy, x, chunk=4096):
    """The float64 weight gradient: per tap, dyᵀ · x shifted, summed over
    row chunks (DGEMM on the card)."""
    d, size = dy.shape[2], x.shape[2]
    out = torch.zeros((32, 4, 3, 3, 3), dtype=torch.float64, device=dy.device)
    for r in range(0, dy.shape[0], chunk):
        dyc = dy[r:r + chunk].permute(0, 2, 3, 4, 1).double().reshape(-1, 32)
        xc = x[r:r + chunk].permute(0, 2, 3, 4, 1).double()
        for tz in range(3):
            for ty in range(3):
                for tx in range(3):
                    xs = xc[:, tz:tz + d, ty:ty + d, tx:tx + d].reshape(-1, 4)
                    out[:, :, tz, ty, tx] += dyc.T @ xs
        del dyc, xc
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", [
    (HALO3, 1), (HALO3, 7), (HALO3, 129), (HALO3, 16_384), (HALO3, 17_536), (HALO3, 40_000),
    (HALO1, 1), (HALO1, 129), (HALO1, 32_768),
])
def test_cuda_kernel_against_an_exact_sum(shape, rows):
    """K9 against the float64 sum, no further from it than twice cuDNN's
    own weight gradient (the plain version) on the same bf16 inputs; 40,000
    rows put dy past 2^31 elements (cuDNN runs it in batch chunks, K9 in
    one launch)."""
    _need_cuda()
    dy, x = _card_inputs(rows, shape[0], rows)
    before = _launches()
    got = conv3d_valid_wgrad(dy, x)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert got.shape == (32, 4, 3, 3, 3) and got.dtype == torch.bfloat16 and got.is_contiguous()
    exact = _exact(dy, x)
    top = exact.abs().max().item()
    err = (got.double() - exact).abs().max().item() / top
    lib_err = (conv3d_valid_wgrad_plain(dy, x).double() - exact).abs().max().item() / top
    assert err <= 2 * lib_err, (err, lib_err)
    assert torch.equal(conv3d_valid_wgrad(dy, x), got)  # no atomics: launch to launch the same


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGRAD_FORMS)
def test_cuda_zero_pad_channel_is_exactly_zero(shape):
    _need_cuda()
    dy, x = _card_inputs(300, shape[0], 5, pad_channel=True)
    got = conv3d_valid_wgrad(dy, x)
    assert torch.equal(got[:, 3], torch.zeros_like(got[:, 3]))
    assert (got[:, :3] != 0).all()


@pytest.mark.cuda
def test_cuda_wrapper_refuses_instead_of_falling_back():
    _need_cuda()
    dy, x = _card_inputs(4, 14, 0)
    before = _launches()
    with pytest.raises(TypeError, match="bf16"):
        conv3d_valid_wgrad(dy.float(), x.float())
    with pytest.raises(ValueError, match="no form"):
        conv3d_valid_wgrad(*_card_inputs(4, 12, 0))
    with pytest.raises(ValueError, match="no form"):  # ef_dim 16
        conv3d_valid_wgrad(dy[:, :16].contiguous(memory_format=torch.channels_last_3d), x)
    with pytest.raises(ValueError, match="no form"):  # x's three RGB channels alone
        conv3d_valid_wgrad(dy, x[:, :3].contiguous(memory_format=torch.channels_last_3d))
    with pytest.raises(ValueError, match="channels-last"):
        conv3d_valid_wgrad(dy.contiguous(), x)
    with pytest.raises(ValueError, match="channels-last"):
        conv3d_valid_wgrad(dy, x.contiguous())
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("x_grad", [False, True])
@pytest.mark.parametrize("w_grad", [False, True])
@pytest.mark.parametrize("dtype,autocast,form", [
    (torch.bfloat16, False, True), (torch.float32, True, True), (torch.float32, False, False),
])
def test_cuda_takes_kernel_wgrad(dtype, autocast, form, w_grad, x_grad):
    """On the card: the weight needs a gradient and the compute dtype is
    bf16 (bf16 tensors or bf16 autocast); the input's gradient does not
    matter."""
    _need_cuda()
    x = torch.zeros(2, 4, 14, 14, 14, dtype=dtype, device="cuda", requires_grad=x_grad)
    w = torch.zeros(32, 4, 3, 3, 3, dtype=dtype, device="cuda", requires_grad=w_grad)
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
        assert takes_kernel_wgrad(x, w) is (form and w_grad)
        with torch.no_grad():
            assert not takes_kernel_wgrad(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("ef_dim,launches", [(32, 1), (8, 0), (16, 0)])
def test_cuda_compact_train_step_launches(ef_dim, launches):
    """A bf16 train step (forward, backward, Adam) of the windowed_compact
    voxel encoder: block 1 takes K9 once at the flagship width, and at an
    ``ef_dim`` K9 is not built for keeps cuDNN's weight gradient (no launch,
    no refusal); never without a gradient or in eval."""
    _need_cuda()
    from tricolo_tpu_torch.models.voxel_cnn import VoxelCNNEncoder

    torch.manual_seed(0)
    enc = VoxelCNNEncoder(ef_dim=ef_dim, compute_dtype=torch.bfloat16).cuda().train()
    opt = torch.optim.Adam(enc.parameters(), lr=1e-3)
    batch, k = 2, 6
    g = torch.Generator().manual_seed(1)
    rgb = torch.randint(0, 2**24, (batch, k, 14**3), generator=g, dtype=torch.int32)
    occ = (torch.rand((batch, k, 14**3), generator=g) < 0.4).to(torch.int32) << 24
    rows = (rgb | occ).cuda()
    ids = torch.stack([torch.randperm(512, generator=g)[:k] for _ in range(batch)])
    ids = ids.to(torch.int32).cuda()
    before = _launches()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = enc(rows, ids)
    out.float().square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in enc.parameters())
    opt.step()
    torch.cuda.synchronize()
    assert _launches() == before + launches
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        enc(rows, ids)
    enc.eval()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        enc(rows, ids)
    assert _launches() == before + launches
