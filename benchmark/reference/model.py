"""The plain Tri(I+V) / Bi(I) model: BiGRU, MVCNN over ResNet18 and the
dense masked (submanifold) VoxelCNN, in float32 torch.

Written from the TriCoLo model's description (arXiv:2201.07366 and its
reference code's encoders), not from the program. Parameters are one flat
dict keyed by the names the program's ``state_dict`` uses, so that the
benchmark can hand the same seeded weights to both; ``param_specs`` lists
them from the configuration's widths alone.

* Text: embedding (token 0 zeroed), one bidirectional GRU layer from a zero
  state over all ``max_tokens`` positions (gates r, z, n;
  n = tanh(W_in x + b_in + r·(W_hn h + b_hn))), the two final states
  concatenated → Linear → tanh → L2.
* Image: views normalised with CLIP's mean and std, ResNet18 (7×7/2 stem,
  BN, ReLU, 3×3/2 max pool, four stages of two basic blocks, global mean),
  max over views, Linear → MLP (Linear, ReLU, Linear) → L2.
* Voxel: RGB/255 on the occupied sites of the D³ grid; five blocks of
  3³ SAME conv (no bias) → BN over the active sites → ReLU → zero the
  inactive sites → 2³ max pool, the active set max-pooled with it
  (channels 3 → ef, 2ef, 4ef, 8ef, z); the channels-last flatten →
  MLP → L2.

BatchNorm in train mode normalises with the batch's biased statistics and
moves its running statistics as ``0.9·running + 0.1·batch``. ``q`` is the
operand rounding of every convolution and matrix product: the identity for
the f32 reference, ``precision.fp8`` for the control.

``Model.voxel_blocked`` is the voxel encoder over the batch in blocks of
samples, for a configuration whose whole-batch graph does not fit the card
(``train.reference_voxel_block``): the same arithmetic, with each
BatchNorm's statistics still over the whole batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
EPS = 1e-5
MOMENTUM = 0.9
STAGES = (2, 2, 2, 2)  # ResNet18


VOXEL_DIMS, VOXEL_SHAPE = (0, 2, 3, 4), (1, -1, 1, 1, 1)  # a voxel BN's sums, its (C,) view


def identity(x, amax=None):
    return x


def _uniform(name, shape, fan_in):
    return (name, tuple(shape), "uniform", fan_in ** -0.5)


def _bn(prefix, c):
    return [(f"{prefix}.weight", (c,), "ones", 0.0), (f"{prefix}.bias", (c,), "zeros", 0.0),
            (f"{prefix}.running_mean", (c,), "zeros", 0.0),
            (f"{prefix}.running_var", (c,), "ones", 0.0),
            (f"{prefix}.num_batches_tracked", (), "count", 0.0)]


def _linear(prefix, cin, cout):
    return [_uniform(f"{prefix}.weight", (cout, cin), cin),
            _uniform(f"{prefix}.bias", (cout,), cin)]


def resnet_blocks():
    """(prefix, cin, features, stride) of ResNet18's basic blocks."""
    out, cin = [], 64
    for stage, n in enumerate(STAGES):
        features = 64 * 2**stage
        for i in range(n):
            out.append((f"layer{stage + 1}.{i}", cin, features,
                        2 if stage > 0 and i == 0 else 1))
            cin = features
    return out


def param_specs(m: dict) -> list:
    """(name, shape, kind, bound) of every parameter and BN buffer, from
    the configuration's ``model`` widths ``m``. Kinds: ``uniform`` (±bound),
    ``uniform_pad`` (±bound, the 4th input channel zero), ``normal``,
    ``ones``, ``zeros``, ``count``."""
    E, H, out = m["embed_dim"], m["gru_hidden"], m["out_dim"]
    specs = [("text_encoder.embedding.weight", (m["vocab_size"], E), "normal", 1.0)]
    for sfx in ("", "_reverse"):
        for kind, cin in (("ih", E), ("hh", H)):
            specs.append((f"text_encoder.gru.weight_{kind}_l0{sfx}", (3 * H, cin), "uniform",
                          H ** -0.5))
        for kind in ("ih", "hh"):
            specs.append((f"text_encoder.gru.bias_{kind}_l0{sfx}", (3 * H,), "uniform",
                          H ** -0.5))
    specs += _linear("text_encoder.fc", 2 * H, out)
    if m["image"]:
        p = "image_encoder.backbone"
        specs.append(_uniform(f"{p}.conv1.weight", (64, 3, 7, 7), 3 * 49))
        specs += _bn(f"{p}.bn1", 64)
        for prefix, cin, f, stride in resnet_blocks():
            b = f"{p}.{prefix}"
            specs.append(_uniform(f"{b}.conv1.weight", (f, cin, 3, 3), cin * 9))
            specs += _bn(f"{b}.bn1", f)
            specs.append(_uniform(f"{b}.conv2.weight", (f, f, 3, 3), f * 9))
            specs += _bn(f"{b}.bn2", f)
            if stride != 1 or cin != f:
                specs.append(_uniform(f"{b}.downsample_conv.weight", (f, cin, 1, 1), cin))
                specs += _bn(f"{b}.downsample_bn", f)
        specs += _linear("image_encoder.fc", 512, m["image_z_dim"])
        specs += _linear("image_encoder.head.fc1", m["image_z_dim"], out)
        specs += _linear("image_encoder.head.fc2", out, out)
    if m["voxel"]:
        chans = voxel_channels(m)
        for i, (cin, cout) in enumerate(zip((4,) + chans[:-1], chans)):
            kind, fan = ("uniform_pad", 27 * 3) if i == 0 else ("uniform", 27 * cin)
            specs.append((f"voxel_encoder.blocks.{i}.conv.weight", (cout, cin, 3, 3, 3), kind,
                          fan ** -0.5))
            specs += _bn(f"voxel_encoder.blocks.{i}.bn", cout)
        flat = (m["voxel_size"] // 32) ** 3 * chans[-1]
        specs += _linear("voxel_encoder.head.fc1", flat, out)
        specs += _linear("voxel_encoder.head.fc2", out, out)
    return specs


def voxel_channels(m: dict) -> tuple:
    ef = m["ef_dim"]
    return (ef, 2 * ef, 4 * ef, 8 * ef, m["voxel_z_dim"])


def trainable(specs) -> list:
    return [name for name, _, kind, _ in specs if kind in ("uniform", "uniform_pad", "normal")
            or (kind in ("ones", "zeros") and not name.endswith(("running_mean", "running_var")))]


def running(specs) -> list:
    return [name for name, *_ in specs if name.endswith(("running_mean", "running_var"))]


def l2n(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def linear(x, w, b, q):
    return F.linear(q(x), q(w), b)


class Model:
    """The plain forward over a weight dict ``w`` (trainable leaves) and a
    dict ``stats`` of running statistics, which a train-mode forward
    replaces with their moved values."""

    def __init__(self, m: dict, w: dict, stats: dict, q=identity):
        self.m, self.w, self.stats, self.q = m, w, stats, q

    # -- text ---------------------------------------------------------------
    def text(self, tokens):
        w, q = self.w, self.q
        p = "text_encoder"
        x = w[f"{p}.embedding.weight"][tokens] * (tokens != 0)[..., None].float()
        finals = [self._gru(x, sfx, reverse) for sfx, reverse in (("", False), ("_reverse", True))]
        h = torch.cat(finals, dim=-1)
        return l2n(torch.tanh(linear(h, w[f"{p}.fc.weight"], w[f"{p}.fc.bias"], q)))

    def _gru(self, x, sfx, reverse):
        w, q = self.w, self.q
        p = "text_encoder.gru"
        H = self.m["gru_hidden"]
        gi = linear(x, w[f"{p}.weight_ih_l0{sfx}"], w[f"{p}.bias_ih_l0{sfx}"], q)
        w_hh, b_hh = w[f"{p}.weight_hh_l0{sfx}"], w[f"{p}.bias_hh_l0{sfx}"]
        h = x.new_zeros(x.shape[0], H)
        steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
        for t in steps:
            gh = linear(h, w_hh, b_hh, q)
            r = torch.sigmoid(gi[:, t, :H] + gh[:, :H])
            z = torch.sigmoid(gi[:, t, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(gi[:, t, 2 * H:] + r * gh[:, 2 * H:])
            h = (1.0 - z) * n + z * h
        return h

    # -- image --------------------------------------------------------------
    def _bn(self, x, prefix, mask=None):
        """Train-mode BN over dims (0, 2, ...) — over the ``mask`` sites
        when given — and the running statistics' move."""
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if mask is None:
            mean = x.mean(dim=dims)
            var = (x - mean.view(shape)).square().mean(dim=dims)
        else:
            n = mask.sum()
            mean = (x * mask).sum(dim=dims) / n
            var = ((x - mean.view(shape)).square() * mask).sum(dim=dims) / n
        for key, value in (("running_mean", mean), ("running_var", var)):
            name = f"{prefix}.{key}"
            self.stats[name] = MOMENTUM * self.stats[name] + (1.0 - MOMENTUM) * value.detach()
        inv = torch.rsqrt(var + EPS)
        return ((x - mean.view(shape)) * inv.view(shape) * self.w[f"{prefix}.weight"].view(shape)
                + self.w[f"{prefix}.bias"].view(shape))

    def _conv2d(self, x, name, stride, padding):
        return F.conv2d(self.q(x), self.q(self.w[name]), stride=stride, padding=padding)

    def image(self, images_u8):
        """images (B, V, H, W, 3) uint8."""
        w, q = self.w, self.q
        B, V = images_u8.shape[:2]
        mean = torch.tensor(CLIP_MEAN, device=images_u8.device)
        std = torch.tensor(CLIP_STD, device=images_u8.device)
        x = ((images_u8.float() / 255.0 - mean) / std).reshape(B * V, *images_u8.shape[2:])
        x = x.permute(0, 3, 1, 2)
        p = "image_encoder.backbone"
        x = torch.relu(self._bn(self._conv2d(x, f"{p}.conv1.weight", 2, 3), f"{p}.bn1"))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for prefix, cin, f, stride in resnet_blocks():
            b = f"{p}.{prefix}"
            y = torch.relu(self._bn(self._conv2d(x, f"{b}.conv1.weight", stride, 1), f"{b}.bn1"))
            y = self._bn(self._conv2d(y, f"{b}.conv2.weight", 1, 1), f"{b}.bn2")
            if stride != 1 or cin != f:
                x = self._bn(self._conv2d(x, f"{b}.downsample_conv.weight", stride, 0),
                             f"{b}.downsample_bn")
            x = torch.relu(y + x)
        features = x.mean(dim=(2, 3)).reshape(B, V, -1).amax(dim=1)
        z = linear(features, w["image_encoder.fc.weight"], w["image_encoder.fc.bias"], q)
        return l2n(self._head("image_encoder.head", z))

    def _head(self, p, x):
        w, q = self.w, self.q
        x = torch.relu(linear(x, w[f"{p}.fc1.weight"], w[f"{p}.fc1.bias"], q))
        return linear(x, w[f"{p}.fc2.weight"], w[f"{p}.fc2.bias"], q)

    # -- voxel --------------------------------------------------------------
    def voxel(self, rgb, occupied):
        """rgb (B, D, D, D, 3) float in [0, 1], occupied (B, D, D, D) 0/1."""
        x = (rgb * occupied[..., None]).permute(0, 4, 1, 2, 3)
        mask = occupied[:, None]
        for i in range(5):
            p = f"voxel_encoder.blocks.{i}"
            weight = self.w[f"{p}.conv.weight"]
            if i == 0:
                weight = weight[:, :3]  # the published 3 input channels
            y = F.conv3d(self.q(x), self.q(weight), padding=1)
            y = torch.relu(self._bn(y, f"{p}.bn", mask)) * mask
            x, mask = F.max_pool3d(y, 2), F.max_pool3d(mask, 2)
        flat = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        return l2n(self._head("voxel_encoder.head", flat))

    def voxel_blocked(self, rgb, occupied, block: int):
        """``voxel`` over the samples in blocks of ``block``. Each BatchNorm
        takes its mean and then its variance (Σ (y − mean)²·m / n) over the
        occupied sites of the whole batch, summed block by block, and moves
        the running statistics once; the control's rounding takes its scale
        from the whole batch's operand. Between the forward and the backward
        only the inputs and each block's pooled outputs are kept: the
        backward computes a block's convolution again (``_Recomputed``), so
        the memory follows the block, not the batch."""
        cuts = [slice(a, a + block) for a in range(0, rgb.shape[0], block)]
        xs = [(rgb[c] * occupied[c, ..., None]).permute(0, 4, 1, 2, 3) for c in cuts]
        masks = [occupied[c, None] for c in cuts]
        run = _Recomputed.apply
        for i in range(5):
            p = f"voxel_encoder.blocks.{i}"
            weight = self.w[f"{p}.conv.weight"]
            if i == 0:
                weight = weight[:, :3]  # the published 3 input channels
            amax = torch.stack([x.detach().abs().amax() for x in xs]).amax()
            sums, squares, pooled = _voxel_passes(self.q, amax)
            n = torch.stack([m.sum() for m in masks]).sum()
            mean = torch.stack([run(sums, x, weight, m) for x, m in zip(xs, masks)]).sum(0) / n
            var = torch.stack([run(squares, x, weight, m, mean)
                               for x, m in zip(xs, masks)]).sum(0) / n
            for key, value in (("running_mean", mean), ("running_var", var)):
                name = f"{p}.bn.{key}"
                self.stats[name] = MOMENTUM * self.stats[name] + (1.0 - MOMENTUM) * value.detach()
            inv = torch.rsqrt(var + EPS)
            gamma, beta = self.w[f"{p}.bn.weight"], self.w[f"{p}.bn.bias"]
            xs = [run(pooled, x, weight, m, mean, inv, gamma, beta) for x, m in zip(xs, masks)]
            masks = [F.max_pool3d(m, 2) for m in masks]
        x = torch.cat(xs)
        flat = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        return l2n(self._head("voxel_encoder.head", flat))


def _voxel_passes(q, amax):
    """One voxel block's three functions of a sample block ``x``, as
    ``Model.voxel`` computes them on the whole batch: the masked sums, the
    masked centred squares, and normalize → ReLU → mask → 2³ max pool."""
    def conv(x, w):
        return F.conv3d(q(x, amax), q(w), padding=1)

    def sums(x, w, m):
        return (conv(x, w) * m).sum(dim=VOXEL_DIMS)

    def squares(x, w, m, mean):
        return ((conv(x, w) - mean.view(VOXEL_SHAPE)).square() * m).sum(dim=VOXEL_DIMS)

    def pooled(x, w, m, mean, inv, gamma, beta):
        y = ((conv(x, w) - mean.view(VOXEL_SHAPE)) * inv.view(VOXEL_SHAPE)
             * gamma.view(VOXEL_SHAPE) + beta.view(VOXEL_SHAPE))
        return F.max_pool3d(torch.relu(y) * m, 2)

    return sums, squares, pooled


class _Recomputed(torch.autograd.Function):
    """``fn(*inputs)`` that keeps only its inputs for the backward and
    computes ``fn`` again there, so that what ``fn`` makes on the way is
    alive only while its own gradient is taken. Unlike
    ``torch.utils.checkpoint``, both what it keeps and what the backward
    computes again pass through autograd's saved-tensor hooks, where the
    tests count them."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.fn = fn
        ctx.save_for_backward(*inputs)
        return fn(*inputs)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            out = ctx.fn(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, *(next(grads) if t.requires_grad else None for t in inputs))


def nt_xent(zi, zj, temperature: float, alpha: float):
    """α·CE(zi·zjᵀ/τ) + (1 − α)·CE(zj·ziᵀ/τ), identity targets, rows L2-normalised."""
    zi, zj = l2n(zi), l2n(zj)
    logits = zi @ zj.T / temperature
    loss_a = -torch.log_softmax(logits, dim=1).diagonal().mean()
    loss_b = -torch.log_softmax(logits.T, dim=1).diagonal().mean()
    return alpha * loss_a + (1.0 - alpha) * loss_b
