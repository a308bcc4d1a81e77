"""K8, the input gradient of the VALID 3³ tile convolution, and the route
that takes it (``ops/conv3d.py``, ``csrc/conv3d_dgrad.cu``), without JAX.

On the CPU: the convolution whose backward takes K8 against autograd of
``F.conv3d`` (input and weight gradients) at both forms and several row
counts; the kernel's layout emulated in numpy — its swizzled dy ring read
as ``ldmatrix`` reads it, the repacked weights as ``mma.m16n8k16`` B
fragments, the fold at each lane's sites and the epilogue — against the
plain version; the work count; which convs K8 takes (``has_form``) and
``ConvBlock``'s routing. On a card (``-m cuda``): the kernel against its
plain version at the main path's row counts and ragged ones, launch to
launch the same, one launch a train step of the compact path and none
without a gradient, a bf16 step at the widths K8 is not built for (which
keeps autograd's input gradient), and the wrapper's refusals. Run the card
tests with

    python -m pytest --noconftest tests/test_torch_conv3d_dgrad.py -m cuda
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from tricolo_tpu_torch.ops.conv3d import (  # noqa: E402
    FORMS,
    conv3d_valid_dgrad,
    conv3d_valid_dgrad_plain,
    conv3d_valid_kernel_dgrad,
    has_form,
    pack_weight,
    takes_kernel_dgrad,
    work,
)

BLOCK2, BLOCK3 = FORMS


def _inputs(rows, size, cin, cout, seed, dtype=torch.float32, device="cpu"):
    """x (R, Cin, S, S, S) as the channels-last view of an NDHWC tensor (as
    ``ConvBlock`` hands it over) and w (Cout, Cin, 3, 3, 3)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, size, size, size, cin), generator=g).to(dtype).to(device)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g) / math.sqrt(27 * cin)).to(dtype)
    return x.permute(0, 4, 1, 2, 3), w.to(device)


def _dy(rows, size, cout, seed, dtype=torch.float32, device="cpu"):
    d = size - 2
    g = torch.Generator().manual_seed(seed)
    dy = torch.randn((rows, d, d, d, cout), generator=g).to(dtype).to(device)
    return dy.permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("shape,rows", [(BLOCK2, 1), (BLOCK2, 3), (BLOCK2, 7),
                                        (BLOCK3, 1), (BLOCK3, 5)])
def test_kernel_dgrad_conv_matches_autograd(shape, rows):
    """f32 on the CPU: forward, input and weight gradients equal autograd of
    ``F.conv3d`` within 1e-5 of each one's largest magnitude (one sum order
    against another)."""
    size, cin, cout = shape
    x, w = _inputs(rows, size, cin, cout, rows)
    dy = _dy(rows, size, cout, rows + 100)
    got_x, got_w = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref_x, ref_w = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = conv3d_valid_kernel_dgrad(got_x, got_w)
    ref = F.conv3d(ref_x, ref_w)
    assert torch.allclose(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())
    got.backward(dy)
    ref.backward(dy)
    for a, b in ((got_x.grad, ref_x.grad), (got_w.grad, ref_w.grad)):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_kernel_dgrad_conv_casts_under_autocast():
    """Under bf16 autocast both operands enter in bf16, as ``F.conv3d``'s
    would, and the f32 weight's gradient comes back in f32."""
    x, w = _inputs(2, *BLOCK2, 0)
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = conv3d_valid_kernel_dgrad(x, w)
        ref = F.conv3d(x, w)
    assert y.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(y, ref)
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32 and x.grad.dtype == torch.float32


# ------------------------------------------------- the kernel's layout, emulated


def _ldmatrix_x4(slot, lane_rows):
    """``ldmatrix.m8n8.x4``: lane l names row l % 8 of matrix l // 8 by the
    (position, stored chunk) it addresses; every lane gets elements
    2(l % 4), 2(l % 4) + 1 of row l // 4 of each matrix. Returns (32, 4, 2)."""
    out = np.empty((32, 4, 2))
    for lane in range(32):
        for j in range(4):
            pos, chunk = lane_rows[8 * j + lane // 4]
            out[lane, j] = slot[pos, chunk, 2 * (lane % 4):2 * (lane % 4) + 2]
    return out


def _a_matrix(regs):
    """The 16 × 16 A operand of ``mma.m16n8k16`` from its lanes' four
    registers: a0a1 (g, 2t), a2a3 (g + 8, 2t), a4a5 (g, 2t + 8), a6a7 (g + 8,
    2t + 8), g = lane // 4, t = lane % 4."""
    a = np.zeros((16, 16))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                        (g + 8, 2 * t + 8))):
            a[row, col:col + 2] = regs[lane, r]
    return a


def _b_matrix(b01, b23):
    """The 16 × 8 B operand (k × n) from its lanes' two registers: b0b1 at
    k = 2t, 2t + 1 and b2b3 at k = 2t + 8, 2t + 9, column n = g."""
    b = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        b[2 * t:2 * t + 2, g] = b01[lane]
        b[2 * t + 8:2 * t + 10, g] = b23[lane]
    return b


def _emulate(dy, w):
    """dx (R, S, S, S, Cin) as ``csrc/conv3d_dgrad.cu`` computes it, its
    indexing step by step, in float64."""
    rows, cout, d = dy.shape[0], dy.shape[1], dy.shape[2]
    cin, size = w.shape[1], d + 2
    P, Q = d**3, size**3
    CC = 110_592 // (27 * cout * 2)  # a block's channels: 27 taps' weights in 110,592 bytes
    MT, KS, TEAM, SD = 256 // cout, cout // 16, CC // 8, CC + 8
    G = 16 * MT // P  # rows a set
    M, chunks = 16 * MT, cout * 2 // 16
    positions = dy.permute(0, 2, 3, 4, 1).reshape(-1, cout).double().numpy()
    packed = pack_weight(w.double()).reshape(cin // CC, 27, TEAM, KS // 2, 32, 8).numpy()
    out = np.full((rows, Q, cin), np.nan)
    for nch in range(cin // CC):
        for s in range(-(-rows // G)):
            slot = np.zeros((M, chunks, 8))  # position, stored 16-byte chunk, element
            for pos in range(M):
                if s * M + pos < rows * P:
                    for c in range(chunks):
                        slot[pos, c ^ (pos & 7)] = positions[s * M + pos, 8 * c:8 * c + 8]
            a = {}
            for mt in range(MT):
                for ks in range(KS):
                    lane_rows = []
                    for lane in range(32):
                        pos = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1)
                        c = 2 * ks + (lane >> 4)
                        lane_rows.append((pos, c ^ (pos & 7)))
                    a[mt, ks] = _a_matrix(_ldmatrix_x4(slot, lane_rows))
            tile = np.zeros(G * Q * SD)
            for wc in range(TEAM):
                for tap in range(27):
                    words = packed[nch, tap, wc]  # (pair, lane, 8)
                    acc = np.zeros((MT, 16, 8))
                    for ks in range(KS):
                        u = words[ks // 2].reshape(32, 4, 2)  # x, y, z, w words
                        b = _b_matrix(u[:, 2 if ks & 1 else 0], u[:, 3 if ks & 1 else 1])
                        for mt in range(MT):
                            acc[mt] += a[mt, ks] @ b
                    shift = (((tap // 9) * size + (tap // 3) % 3) * size + tap % 3) * SD
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for mt in range(MT):
                            for h in range(2):
                                pos = 16 * mt + 8 * h + g
                                gi, pl = pos // P, pos % P
                                pz, py, px = pl // (d * d), (pl // d) % d, pl % d
                                site = (gi * Q + (pz * size + py) * size + px) * SD + 8 * wc + 2 * t
                                tile[site + shift:site + shift + 2] += acc[mt, 8 * h + g,
                                                                           2 * t:2 * t + 2]
                for gi in range(G):
                    row = s * G + gi
                    if row < rows:
                        for q in range(Q):
                            at = (gi * Q + q) * SD + 8 * wc
                            out[row, q, nch * CC + 8 * wc:nch * CC + 8 * wc + 8] = tile[at:at + 8]
    return torch.from_numpy(out).reshape(rows, size, size, size, cin)


@pytest.mark.parametrize("shape,rows", [(BLOCK2, 2), (BLOCK3, 5)])
def test_emulated_kernel_matches_plain(shape, rows):
    """The kernel's layouts (ring swizzle, ldmatrix, fragment-major weights,
    fold sites, epilogue), emulated in float64, give the plain input
    gradient; a ragged last set at the third block (5 rows, 4 a set)."""
    size, cin, cout = shape
    dy = _dy(rows, size, cout, 7, torch.float64)
    w = _inputs(1, size, cin, cout, 8, torch.float64)[1]
    got = _emulate(dy, w)
    ref = conv3d_valid_dgrad_plain(dy, w).permute(0, 2, 3, 4, 1)
    assert torch.allclose(got, ref, rtol=0, atol=1e-12 * ref.abs().max().item())


def test_pack_weight_is_a_permutation():
    w = torch.arange(64 * 32 * 27, dtype=torch.float64).reshape(64, 32, 3, 3, 3)
    packed = pack_weight(w)
    assert packed.numel() * 2 == 110_592 and packed.is_contiguous()
    assert torch.equal(packed.flatten().sort().values, w.flatten())
    # chunk 0, tap 0, group 0, pair 0, lane 0: channel 0, k = 0, 1, 8, 9, 16, 17, 24, 25
    assert packed.flatten()[:8].tolist() == [w[k, 0, 0, 0, 0].item()
                                             for k in (0, 1, 8, 9, 16, 17, 24, 25)]


def test_work_is_the_true_work():
    """At train_spread's rows: 7.08 MFLOP, 8,192 bytes of dy and 13,824 of
    dx a row, the weights once."""
    nbytes, flops = work(17_536, *BLOCK2)
    assert flops == 17_536 * 64 * 64 * 32 * 27 * 2 == 124_117_843_968
    assert nbytes == 17_536 * (8_192 + 13_824) + 110_592


def test_work_counter_classes_k8_as_bf16():
    from tricolo_tpu_torch import ops, work as _work

    assert _work.LABELS["conv3d_valid_dgrad"] == "K8"
    assert "conv3d_valid_dgrad" in ops.launches()
    counter = _work.WorkCounter()
    with counter.kernel("K8", work, (128, *BLOCK2)):
        pass
    assert counter.records[0][:3] == [0, "K8", "bf16"]


def test_cpu_tensors_take_the_plain_version():
    from tricolo_tpu_torch import ops

    ops.reset_launches()
    dy = _dy(3, *BLOCK2[::2], 1)
    w = _inputs(1, *BLOCK2, 2)[1]
    assert torch.equal(conv3d_valid_dgrad(dy, w), conv3d_valid_dgrad_plain(dy, w))
    assert ops.launches()["conv3d_valid_dgrad"] == 0


@pytest.mark.parametrize("dtype,x_shape,w_shape,want", [
    (torch.bfloat16, (7, 32, 6, 6, 6), (64, 32, 3, 3, 3), True),  # block 2, ef_dim 32
    (torch.bfloat16, (7, 64, 4, 4, 4), (128, 64, 3, 3, 3), True),  # the dense plan's third
    (torch.float32, (7, 32, 6, 6, 6), (64, 32, 3, 3, 3), False),  # an f32-compute step
    (torch.float16, (7, 32, 6, 6, 6), (64, 32, 3, 3, 3), False),
    (torch.bfloat16, (7, 8, 6, 6, 6), (16, 8, 3, 3, 3), False),  # ef_dim 8
    (torch.bfloat16, (7, 16, 6, 6, 6), (32, 16, 3, 3, 3), False),  # ef_dim 16
    (torch.bfloat16, (7, 32, 4, 4, 4), (64, 32, 3, 3, 3), False),  # block 2 on 4³ tiles
    (torch.bfloat16, (7, 32, 6, 6, 6), (64, 32, 1, 1, 1), False),  # not 3³ taps
])
def test_has_form(dtype, x_shape, w_shape, want):
    """K8 takes a conv's input gradient in bf16 at the forms of ``FORMS``
    alone, so no width the ``ef_dim`` key allows reaches its refusal."""
    assert has_form(dtype, x_shape, w_shape) is want


def test_takes_kernel_dgrad_never_on_the_cpu():
    """The CPU keeps ``F.conv3d``'s one backward, whatever the dtype."""
    w = torch.zeros(64, 32, 3, 3, 3, dtype=torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(2, 32, 6, 6, 6, dtype=dtype, requires_grad=True)
        assert not takes_kernel_dgrad(x, w.to(dtype))
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert not takes_kernel_dgrad(x, w)


def _as_on_the_card(x, w):
    """``takes_kernel_dgrad`` as a bf16 step on the card decides it."""
    return x.requires_grad and torch.is_grad_enabled() and has_form(torch.bfloat16, x.shape,
                                                                      w.shape)


@pytest.mark.parametrize("case", ["valid_grad", "valid_no_grad", "valid_grad_off", "same_grad",
                                  "explicit", "plain_path", "other_width", "cpu"])
def test_conv_block_routes_only_valid_convs_needing_a_gradient(monkeypatch, case):
    """With the card's decision (``_as_on_the_card``) standing in for the
    device: only a VALID conv at a form of K8 whose input needs a gradient
    takes the route; on the CPU (``cpu``: the real decision) none does."""
    from tricolo_tpu_torch.models import voxel_cnn

    if case != "cpu":
        monkeypatch.setattr(voxel_cnn, "takes_kernel_dgrad", _as_on_the_card)
    calls = []
    for name in ("conv3d_valid_kernel_dgrad", "conv3d_valid_explicit_dgrad"):
        real = getattr(voxel_cnn, name)
        monkeypatch.setattr(voxel_cnn, name,
                            lambda x, w, _real=real, _name=name: calls.append(_name) or _real(x, w))
    cin = 16 if case == "other_width" else 32
    block = voxel_cnn.ConvBlock(cin, 2 * cin).train()
    x = torch.randn(3, 6, 6, 6, cin)
    mask = torch.ones(3, 4, 4, 4, 1)
    kwargs = {}
    if case != "valid_no_grad":
        x.requires_grad_()
    if case == "same_grad":
        kwargs["padding"] = 1
        mask = torch.ones(3, 6, 6, 6, 1)
    if case == "explicit":
        kwargs["explicit_dgrad"] = True
    if case == "plain_path":
        kwargs["use_kernels"] = False
    if case == "valid_grad_off":
        with torch.no_grad():
            block(x, mask, **kwargs)
    else:
        out, _ = block(x, mask, **kwargs)
        if x.requires_grad:
            out.float().sum().backward()
            assert x.grad is not None and x.grad.shape == x.shape
    want = {"valid_grad": ["conv3d_valid_kernel_dgrad"],
            "explicit": ["conv3d_valid_explicit_dgrad"]}.get(case, [])
    assert calls == want


def test_conv_block_gradients_unchanged_by_the_route(monkeypatch):
    """The block's input and weight gradients through the K8 route (taken
    on the CPU as on the card, K8's plain version in its place) equal the
    plain path's (autograd's convolution backward) within f32 noise."""
    from tricolo_tpu_torch.models import voxel_cnn

    routed = []
    monkeypatch.setattr(voxel_cnn, "takes_kernel_dgrad",
                        lambda x, w: routed.append(_as_on_the_card(x, w)) or routed[-1])
    torch.manual_seed(0)
    block = voxel_cnn.ConvBlock(32, 64).train()
    x = torch.randn(4, 6, 6, 6, 32)
    mask = (torch.rand(4, 4, 4, 4, 1) > 0.3).float()
    grads = []
    for use_kernels in (True, False):
        xg = x.clone().requires_grad_()
        block.zero_grad()
        out, _ = block(xg, mask, use_kernels=use_kernels)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append((xg.grad, block.conv.weight.grad.clone()))
    assert routed == [True]  # asked once, by the use_kernels pass
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


# ---------------------------------------------------------------- card


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K8 has no CPU mode")


def _launches() -> int:
    from tricolo_tpu_torch import ops

    return ops.launches()["conv3d_valid_dgrad"]


# K8 against its plain version (cuDNN's convolution_backward in bf16): both
# sum in f32, in different orders (~1e-7 of the sum's terms, under 1e-5 of
# the largest |dx| at these fan-ins), and round once to bf16, so an element
# may land one bf16 ulp apart (at most 2⁻⁷ of its magnitude) where the f32
# sums straddle a rounding boundary.
BF16_ULP = 2.0**-7
SUM_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", [
    (BLOCK2, 17_536), (BLOCK2, 16_384), (BLOCK2, 27_680), (BLOCK2, 32_768),
    (BLOCK2, 1), (BLOCK2, 127), (BLOCK2, 17_537),
    (BLOCK3, 32_768), (BLOCK3, 1), (BLOCK3, 127), (BLOCK3, 4_099),
])
def test_cuda_kernel_matches_plain(shape, rows):
    _need_cuda()
    size, cin, cout = shape
    dy = _dy(rows, size, cout, rows, torch.bfloat16, "cuda")
    w = _inputs(1, size, cin, cout, rows + 1, torch.bfloat16, "cuda")[1]
    before = _launches()
    got = conv3d_valid_dgrad(dy, w)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert got.shape == (rows, cin, size, size, size) and got.dtype == torch.bfloat16
    assert got.permute(0, 2, 3, 4, 1).is_contiguous()
    ref = conv3d_valid_dgrad_plain(dy, w).float()
    err = (got.float() - ref).abs() - BF16_ULP * ref.abs()
    assert err.max().item() <= SUM_TOL * ref.abs().max().item()
    assert torch.equal(conv3d_valid_dgrad(dy, w), got)  # no atomics: launch to launch the same


@pytest.mark.cuda
@pytest.mark.parametrize("ef_dim,launches", [(32, 1), (8, 0), (16, 0)])
def test_cuda_compact_train_step_launches(ef_dim, launches):
    """A bf16 train step (forward, backward, Adam) of the windowed_compact
    voxel encoder: block 2 takes K8 once at the flagship width, and at an
    ``ef_dim`` K8 is not built for keeps autograd's input gradient (no
    launch, no refusal); never without a gradient or in eval."""
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
    assert all(torch.isfinite(p).all() for p in enc.parameters())
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        enc(rows, ids)
    enc.eval()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        enc(rows, ids)
    assert _launches() == before + launches


@pytest.mark.cuda
def test_cuda_wrapper_refuses_instead_of_falling_back():
    _need_cuda()
    dy = _dy(4, 6, 64, 0, torch.bfloat16, "cuda")
    w = _inputs(1, *BLOCK2, 1, torch.bfloat16, "cuda")[1]
    before = _launches()
    with pytest.raises(TypeError, match="bf16"):
        conv3d_valid_dgrad(dy.float(), w.float())
    with pytest.raises(ValueError, match="no form"):
        conv3d_valid_dgrad(_dy(4, 5, 64, 0, torch.bfloat16, "cuda"), w)
    with pytest.raises(ValueError, match="no form"):
        conv3d_valid_dgrad(dy[:, :32].contiguous(memory_format=torch.channels_last_3d),
                           w[:32])
    with pytest.raises(ValueError, match="channels-last"):
        conv3d_valid_dgrad(dy.contiguous(), w)
    assert _launches() == before
