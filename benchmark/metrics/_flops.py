"""The model's FLOPs of one train step, from shapes alone (``step_mfu``).

The count is the model's work, whatever implements it, so that no exact
implementation can exceed it and one that skips work is credited:

* BiGRU: the cuDNN-RNN formula 2·rows·3·H·(I + H) a direction (rows = B·T,
  every padded position, as the GRU runs over all of them), times 3 for
  forward and backward (the embedding is trained, so the input gradient
  is needed); the projection 2·B·2H·out, times 3.
* ResNet18 over the B·V views: each convolution 2·N·Ho·Wo·Cout·Cin·k², each
  linear layer 2·N·in·out; times 3, except the stem convolution, whose
  input (the images) needs no gradient: times 2.
* Voxel encoder: each submanifold 3³ convolution 2·27·Cin·Cout per active
  site of its input grid (the sites of the batch's shapes at D, D/2, ...,
  D/16), with the published 3 input channels at block 1; times 3, except
  block 1 (its input needs no gradient): times 2. The head's linear
  layers times 3. Recomputation is not counted.
* NT-Xent: each pair's logits 2·B²·D forward and two such products
  backward: 6·B²·D a pair.

BatchNorm, activations, pooling and Adam are not counted.
"""

from __future__ import annotations

from itertools import combinations

STAGES = (2, 2, 2, 2)


def text(B: int, T: int, embed: int, hidden: int, out: int) -> float:
    gru = 2 * (2 * B * T * 3 * hidden * (embed + hidden))
    return 3.0 * (gru + 2 * B * 2 * hidden * out)


def resnet18(N: int, size: int) -> float:
    """Forward + backward of ResNet18 on N images of size²."""
    s = size // 2
    total = 2.0 * (2 * N * s * s * 64 * 3 * 49)  # the stem: no input gradient
    s = -(-s // 2)  # the 3×3/2 max pool
    cin = 64
    for stage, blocks in enumerate(STAGES):
        f = 64 * 2**stage
        for i in range(blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            so = -(-s // stride)
            fwd = 2 * N * so * so * f * cin * 9 + 2 * N * so * so * f * f * 9
            if stride != 1 or cin != f:
                fwd += 2 * N * so * so * f * cin
            total += 3.0 * fwd
            s, cin = so, f
    return total


def image(B: int, V: int, size: int, z_dim: int, out: int) -> float:
    heads = 2 * B * 512 * z_dim + 2 * B * z_dim * out + 2 * B * out * out
    return resnet18(B * V, size) + 3.0 * heads


def voxel(active: list, channels: tuple, B: int, flat: int, out: int) -> float:
    """``active``: the batch's active sites at each block's input grid."""
    cins = (3,) + tuple(channels[:-1])
    total = 0.0
    for i, (n, cin, cout) in enumerate(zip(active, cins, channels)):
        total += (2.0 if i == 0 else 3.0) * 2 * 27 * cin * cout * float(n)
    return total + 3.0 * (2 * B * flat * out + 2 * B * out * out)


def loss(modalities: int, B: int, D: int) -> float:
    pairs = len(list(combinations(range(modalities), 2)))
    return pairs * 6.0 * B * B * D


def step(m: dict, B: int, active: list | None) -> float:
    """One step's FLOPs for the configuration's widths ``m``; ``active``
    the batch's active sites a block (None without the voxel encoder)."""
    total = text(B, m["max_tokens"], m["embed_dim"], m["gru_hidden"], m["out_dim"])
    modalities = 1
    if m["image"]:
        total += image(B, m["num_views"], m["image_size"], m["image_z_dim"], m["out_dim"])
        modalities += 1
    if m["voxel"]:
        ef = m["ef_dim"]
        channels = (ef, 2 * ef, 4 * ef, 8 * ef, m["voxel_z_dim"])
        flat = (m["voxel_size"] // 32) ** 3 * m["voxel_z_dim"]
        total += voxel(active, channels, B, flat, m["out_dim"])
        modalities += 1
    return total + loss(modalities, B, m["out_dim"])
