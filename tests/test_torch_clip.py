"""The CLIP-head configurations in the port against the JAX package: the
heads, the Tri(CLIP-I+V) forward, the weight bridge, the CLIP BPE
tokenizer, the feature-cache extractor and its CLI, the datasets'
precached-feature fields, collation, and the CLIP-text server.

All on the CPU at small widths (voxel 32, ef_dim 8, B=2, f32), weights
carried from the JAX package by ``convert.jax_to_torch``. Tolerances: the
heads in eval mode 1e-5 of the largest magnitude (two f32 GEMMs); the
Tri(CLIP-I+V) features and the index atol 1e-4 (the voxel convolutions sum
in another order, as in ``test_torch_data.py``); query scores atol 1e-5;
tokenizer ids, cache files, dataset items and the convert round trip
exactly equal. No CLIP weights or BPE file are needed: a miniature merges
file (the writer of ``tests/test_clip.py``), its deterministic fake
backend, and a stub text backend (as ``tests/test_serving.py``'s) stand in.
"""

import ast
import gzip
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_clip import FakeBackend  # noqa: E402
from test_data import make_disk_dataset  # noqa: E402
from test_torch_data import (  # noqa: E402
    TINY,
    _numpy_tree,
    _randomize_bn,
    host_batch,
    jax_device_batch,
)
from test_torch_train import _flat  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CLIP = ["model.text_encoder=CLIPTextEncoder", "model.image_encoder=CLIPImageEncoder"]
# Tri(CLIP-I+V): both CLIP heads and the tiny voxel encoder.
CLIP_TRI = [*TINY, *CLIP]
# Bi(CLIP-I): the two heads alone, a model without any BatchNorm.
CLIP_BI = [*CLIP_TRI, "model.voxel_encoder=null"]
FEATURE_KEYS = ("text_features", "image_features", "voxel_features")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The test workers share the CPU: keep this module's PyTorch ops from
    oversubscribing it (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def write_tiny_bpe(path):
    """A miniature merges file in the OpenAI format (version header first);
    the writer of ``tests/test_clip.py``."""
    merges = [
        ("h", "e"),          # he
        ("l", "l"),          # ll
        ("he", "ll"),        # hell
        ("o", "</w>"),       # o</w>
        ("hell", "o</w>"),   # hello</w>
        ("w", "o"),          # wo
        ("r", "l"),          # rl
        ("rl", "d</w>"),     # rld</w>
        ("wo", "rld</w>"),   # world</w>
    ]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: tiny\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return merges


class StubBackend:
    """Deterministic CLIP text stand-in: the token ids / 1000 in the first
    77 of 768 dimensions (``tests/test_serving.py``'s stub)."""

    def encode_text(self, tokens):
        tokens = np.asarray(tokens, np.float32)
        out = np.zeros((tokens.shape[0], 768), np.float32)
        out[:, : tokens.shape[1]] = tokens / 1000.0
        return out


@pytest.fixture
def tiny_bpe(tmp_path, monkeypatch):
    """The tiny merges file as ``TRICOLO_CLIP_BPE``; the JAX package's
    cached default tokenizer is cleared now and restored afterwards."""
    import tricolo_tpu.clip.tokenizer as jax_tokenizer

    path = str(tmp_path / "bpe.txt.gz")
    write_tiny_bpe(path)
    monkeypatch.setenv("TRICOLO_CLIP_BPE", path)
    monkeypatch.setattr(jax_tokenizer, "_DEFAULT", None)
    return path


def jax_cfg(extra):
    from tricolo_tpu.config import load_config

    return load_config(list(extra))


def torch_cfg(extra):
    from tricolo_tpu_torch.config import load_config

    return load_config(list(extra))


def jax_clip_variables(overrides, seed=0):
    """(model, params, batch_stats) of the JAX TriCoLoNet for
    ``overrides``: numpy trees, random BN state, ``{}`` without BN."""
    from tricolo_tpu.models.tricolo_net import TriCoLoNet

    cfg = jax_cfg(overrides)
    model = TriCoLoNet.from_config(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jax_device_batch(host_batch(cfg), cfg))
    params = _numpy_tree(variables["params"])
    stats = _numpy_tree(variables.get("batch_stats", {}))
    _randomize_bn(params, stats, np.random.default_rng(seed))
    return model, params, stats


def port_model(params, stats, overrides):
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    model = TriCoLoNet.from_config(torch_cfg(overrides))
    model.load_state_dict(jax_to_torch(params, stats))
    return model.eval()


@pytest.fixture(scope="module")
def clip_tri():
    return jax_clip_variables(CLIP_TRI, seed=3)


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("name", ["CLIPTextEncoder", "CLIPImageEncoder"])
def test_clip_head_eval_matches_jax(name):
    """The head in eval mode against JAX ``deterministic=True``: 1e-5 of
    the largest magnitude; float32 out, not L2-normalised."""
    from tricolo_tpu.models import clip_heads as jax_heads
    from tricolo_tpu_torch.convert import jax_to_torch
    from tricolo_tpu_torch.models import clip_heads

    x = np.random.default_rng(1).standard_normal((6, 768)).astype(np.float32)
    head = getattr(jax_heads, name)(out_dim=64, feature_dim=768, dropout=0.1)
    variables = head.init(jax.random.PRNGKey(2), x)
    ref = np.asarray(head.apply(variables, x, deterministic=True))
    port = getattr(clip_heads, name)(out_dim=64, feature_dim=768, dropout=0.1)
    port.load_state_dict(jax_to_torch(_numpy_tree(variables["params"]), {}))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (6, 64)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert not np.allclose(np.linalg.norm(ref, axis=-1), 1.0)


def test_tri_clip_forward_matches_jax(clip_tri):
    """Tri(CLIP-I+V) eval forward at voxel 32: every feature within 1e-4."""
    from tricolo_tpu_torch.inference import eval_step, to_device_batch

    model, params, stats = clip_tri
    cfg = jax_cfg(CLIP_TRI)
    batch = host_batch(cfg)
    ref = model.apply({"params": params, "batch_stats": stats},
                      jax_device_batch(batch, cfg), train=False)
    port = port_model(params, stats, CLIP_TRI)
    got = eval_step(port, to_device_batch(batch, CPU))
    assert sorted(got) == sorted(FEATURE_KEYS)
    for key in FEATURE_KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("where,name", [("text", "GRUEncoder"), ("image", "EfficientNetB0")])
def test_unknown_encoder_names_raise(where, name):
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    with pytest.raises(ValueError, match=f"unknown {where} encoder: {name}"):
        TriCoLoNet.from_config(torch_cfg([*CLIP_TRI, f"model.{where}_encoder={name}"]))


def test_from_config_reads_clip_keys():
    """``clip_feature_dim`` and the text head's dropout; the image head's
    dropout falls back to the text head's when its key is absent."""
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    cfg = torch_cfg([*CLIP_BI, "model.modules.clip_feature_dim=32",
                     "model.modules.CLIPTextEncoder.dropout=0.3"])
    model = TriCoLoNet.from_config(cfg)
    assert model.text_encoder.head.fc1.in_features == 32
    assert model.text_encoder.head.dropout == 0.3
    assert model.image_encoder.head.dropout == 0.1
    del cfg.model.modules.CLIPImageEncoder["dropout"]
    assert TriCoLoNet.from_config(cfg).image_encoder.head.dropout == 0.3
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in model.modules())


@pytest.mark.parametrize("overrides", [CLIP_TRI, CLIP_BI], ids=["tri", "bi_no_batch_stats"])
def test_convert_round_trip_is_bit_exact(overrides):
    from tricolo_tpu_torch.convert import jax_to_torch, torch_to_jax

    _, params, stats = jax_clip_variables(overrides, seed=4)
    state_dict = jax_to_torch(params, stats)
    model = port_model(params, stats, overrides)
    assert sorted(state_dict) == sorted(model.state_dict())
    assert "text_encoder.head.fc1.weight" in state_dict
    assert "image_encoder.head.fc2.bias" in state_dict
    back_params, back_stats = torch_to_jax(state_dict)
    for ref, got in ((params, back_params), (stats, back_stats)):
        ref, got = _flat(ref), _flat(got)
        assert sorted(ref) == sorted(got)
        for name, value in ref.items():
            assert got[name].dtype == value.dtype and got[name].tobytes() == value.tobytes(), name
    if overrides is CLIP_BI:
        assert stats == {} and back_stats == {}
    again = jax_to_torch(*torch_to_jax(model.state_dict()))
    for name, value in model.state_dict().items():
        assert torch.equal(again[name], value), name


# --------------------------------------------------------------- tokenizer


TOKENIZER_CASES = [
    ("hello world", 8, True),
    ("hex", 16, True),
    ("hello " * 50, 10, True),
    ("HELLO   world", 77, True),
    ("a café-style chair", 77, True),
    ("The &amp; quick  brown chair's 3 legs_x!", 77, True),
    ("hello world " * 40, 77, True),
]


@pytest.mark.parametrize("text,context,truncate", TOKENIZER_CASES)
@pytest.mark.parametrize("gz", [True, False], ids=["gzip", "plain"])
def test_tokenizer_ids_equal_jax(tmp_path, text, context, truncate, gz):
    from tricolo_tpu.clip.tokenizer import ClipTokenizer as JaxTokenizer
    from tricolo_tpu_torch.clip.tokenizer import ClipTokenizer

    path = tmp_path / ("bpe.txt.gz" if gz else "bpe.txt")
    write_tiny_bpe(str(tmp_path / "bpe.txt.gz"))
    if not gz:
        path.write_text(gzip.open(tmp_path / "bpe.txt.gz", "rt", encoding="utf-8").read())
    ours, ref = ClipTokenizer(str(path)), JaxTokenizer(str(tmp_path / "bpe.txt.gz"))
    got = ours(text, context_length=context, truncate=truncate)
    want = ref(text, context_length=context, truncate=truncate)
    assert got.dtype == want.dtype == np.int32 and got.shape == (context,)
    np.testing.assert_array_equal(got, want)
    assert (ours.sot, ours.eot) == (ref.sot, ref.eot) and ours.encoder == ref.encoder


def test_tokenizer_truncation_and_missing_file(tmp_path, monkeypatch):
    from tricolo_tpu_torch.clip.tokenizer import ClipTokenizer

    write_tiny_bpe(str(tmp_path / "bpe.txt.gz"))
    tok = ClipTokenizer(str(tmp_path / "bpe.txt.gz"))
    ids = tok("hello " * 50, context_length=10)
    assert ids[-1] == tok.eot and ids[0] == tok.sot
    with pytest.raises(ValueError, match="longer than context 10"):
        tok("hello " * 50, context_length=10, truncate=False)
    monkeypatch.delenv("TRICOLO_CLIP_BPE", raising=False)
    with pytest.raises(FileNotFoundError, match="BPE"):
        ClipTokenizer()
    with pytest.raises(FileNotFoundError, match="TRICOLO_CLIP_BPE"):
        ClipTokenizer(str(tmp_path / "missing.gz"))
    monkeypatch.setenv("TRICOLO_CLIP_BPE", str(tmp_path / "bpe.txt.gz"))
    np.testing.assert_array_equal(ClipTokenizer()("hello world"), tok("hello world"))


# --------------------------------------------------------------- extraction


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files) and x.files
        for key in x.files:
            assert x[key].dtype == y[key].dtype == np.float32, key
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def test_extract_clip_features_equals_jax(tmp_path):
    """The port's cache of the synthetic val split, through the fake
    backend, equals the JAX package's key for key; the last caption wins."""
    from tricolo_tpu.clip.extract import extract_clip_features as jax_extract
    from tricolo_tpu.clip.tokenizer import ClipTokenizer as JaxTokenizer
    from tricolo_tpu.data import build_dataset as jax_build
    from tricolo_tpu_torch.clip.extract import clip_normalize_images, extract_clip_features
    from tricolo_tpu_torch.clip.tokenizer import ClipTokenizer
    from tricolo_tpu_torch.data import build_dataset

    bpe = str(tmp_path / "bpe.txt.gz")
    write_tiny_bpe(bpe)
    dataset = build_dataset(torch_cfg(["data=synthetic"]), "val")
    cache = extract_clip_features(dataset, FakeBackend(), str(tmp_path / "ours" / "c.npz"),
                                  batch_captions=4, tokenizer=ClipTokenizer(bpe))
    jax_extract(jax_build(jax_cfg(["data=synthetic"]), "val"), FakeBackend(),
                str(tmp_path / "ref" / "c.npz"), batch_captions=4, tokenizer=JaxTokenizer(bpe))
    _same_npz(tmp_path / "ours" / "c.npz", tmp_path / "ref" / "c.npz")
    last = {row["model_id"]: row["text"] for row in dataset.language_data}
    tok = ClipTokenizer(bpe)
    for model_id, text in last.items():
        emb = FakeBackend().encode_text(tok(text)[None])[0]
        np.testing.assert_allclose(cache[model_id]["text"], emb / np.linalg.norm(emb),
                                   rtol=1e-6)
    from tricolo_tpu.clip.extract import clip_normalize_images as jax_normalize

    views = dataset.vision_data[next(iter(dataset.vision_data))]["images"]
    np.testing.assert_array_equal(clip_normalize_images(views), jax_normalize(views))


def _root_script(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_extract_cli_equals_the_root_cli(tmp_path, tiny_bpe, monkeypatch, capsys):
    """``python -m tricolo_tpu_torch.extract_clip_feats`` and the JAX
    package's ``extract_clip_feats.py``, each with the fake backend in place
    of the local checkpoint: the same three cache files; both refuse an
    image size other than 224."""
    import tricolo_tpu.clip.extract as jax_extract
    import tricolo_tpu_torch.clip.extract as port_extract
    from tricolo_tpu_torch import extract_clip_feats

    for module in (jax_extract, port_extract):
        monkeypatch.setattr(module, "TransformersClipBackend", lambda path: FakeBackend())
    args = ["data=synthetic", "data.num_models=3", "data.num_views=2", "data.image_size=224"]
    paths = extract_clip_feats.main([*args, f"data.exp_data_root_path={tmp_path / 'ours'}"])
    _root_script("extract_clip_feats").main([*args,
                                             f"data.exp_data_root_path={tmp_path / 'ref'}"])
    assert [Path(p).name for p in paths] == [f"clip_embeddings_{s}.npz"
                                             for s in ("train", "val", "test")]
    for path in paths:
        _same_npz(path, tmp_path / "ref" / Path(path).name)
    capsys.readouterr()
    with pytest.raises(SystemExit) as info:
        extract_clip_feats.main(["data=synthetic"])
    assert info.value.code == 0
    assert "data.image_size to 224" in capsys.readouterr().out


def test_transformers_backend_needs_a_local_directory(tmp_path):
    from tricolo_tpu_torch.clip.extract import TransformersClipBackend

    with pytest.raises(FileNotFoundError, match="local CLIP checkpoint directory"):
        TransformersClipBackend(str(tmp_path / "absent"))


def test_transformers_is_imported_only_inside_the_backend():
    """No port module imports ``transformers`` at import time: only
    ``TransformersClipBackend.__init__`` does."""
    sites = []
    for path in sorted((ROOT / "tricolo_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        owners = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                owners[child] = node
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] == "transformers" for n in names):
                chain, up = [], owners.get(node)
                while up is not None:
                    if isinstance(up, (ast.FunctionDef, ast.ClassDef)):
                        chain.append(up.name)
                    up = owners.get(up)
                sites.append((path.relative_to(ROOT).as_posix(), chain))
    assert sites == [("tricolo_tpu_torch/clip/extract.py",
                      ["__init__", "TransformersClipBackend"])]


# ------------------------------------------------------------------ datasets


@pytest.mark.parametrize("heads", [CLIP, CLIP[:1], CLIP[1:]], ids=["both", "text", "image"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_items_equal_jax(heads, split):
    from tricolo_tpu.data import build_dataset as jax_build
    from tricolo_tpu_torch.data import build_dataset

    overrides = ["data=synthetic", "model.voxel_encoder=VoxelCNNEncoder", *heads]
    ours, ref = build_dataset(torch_cfg(overrides), split), jax_build(jax_cfg(overrides), split)
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b) and "clip_embeddings_img" in a
        for key, value in b.items():
            if isinstance(value, np.ndarray):
                assert a[key].dtype == value.dtype, key
                np.testing.assert_array_equal(a[key], value, err_msg=key)
            else:
                assert a[key] == value, key


def _write_cache(root, model_ids, fmt):
    """The split's CLIP cache for ``model_ids``: the extractor's npz or the
    reference's ``.pth`` (a nested dict of tensors)."""
    rng = np.random.default_rng(9)
    cache = {m: {"img": rng.standard_normal(768).astype(np.float32),
                 "text": rng.standard_normal(768).astype(np.float32)} for m in model_ids}
    base = str(Path(root) / "clip_embeddings_train")
    if fmt == "npz":
        np.savez(base + ".npz", **{f"{m}/{k}": v for m, e in cache.items() for k, v in e.items()})
    else:
        torch.save({m: {k: torch.from_numpy(v) for k, v in e.items()} for m, e in cache.items()},
                   base + ".pth")
    return cache


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_general_dataset_clip_items_equal_jax(tmp_path, tiny_bpe, fmt):
    """A reference-format split with a CLIP cache covering two of its three
    models: the features attach where the cache has the model, captions
    become CLIP BPE ids (context 77), items equal the JAX dataset's."""
    from tricolo_tpu.data.datasets import GeneralDataset as JaxGeneral
    from tricolo_tpu_torch.data.datasets import GeneralDataset

    make_disk_dataset(str(tmp_path))
    cache = _write_cache(tmp_path, ["m00", "m02"], fmt)
    overrides = ["data=synthetic", "model.voxel_encoder=VoxelCNNEncoder", *CLIP,
                 f"data.exp_data_root_path={tmp_path}",
                 f"data.train_lang_data_path={tmp_path / 'train_map.json'}",
                 "data.image_size=16", "data.num_views=4", "data.max_tokens=12"]
    ours = GeneralDataset(torch_cfg(overrides), "train")
    ref = JaxGeneral(jax_cfg(overrides), "train")
    assert len(ours) == len(ref) == 6
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        assert a["tokens"].shape == (77,)
        for key, value in b.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(a[key], value, err_msg=key)
        if a["model_id"] in cache:
            np.testing.assert_array_equal(a["clip_embeddings_img"], cache[a["model_id"]]["img"])
        else:
            assert "clip_embeddings_text" not in a


def test_general_dataset_clip_text_needs_bpe(tmp_path, monkeypatch):
    from tricolo_tpu_torch.data.datasets import GeneralDataset

    make_disk_dataset(str(tmp_path))
    monkeypatch.delenv("TRICOLO_CLIP_BPE", raising=False)
    overrides = ["data=synthetic", "model.text_encoder=CLIPTextEncoder",
                 f"data.exp_data_root_path={tmp_path}",
                 f"data.train_lang_data_path={tmp_path / 'train_map.json'}"]
    with pytest.raises(FileNotFoundError, match="BPE"):
        GeneralDataset(torch_cfg(overrides), "train")


# --------------------------------------------------------- collation, device


def test_collated_batch_carries_the_clip_fields():
    """Both fields are collated as float32 (B, 768) equal to the JAX
    loader's, copied by ``to_device_batch`` and passed through by
    ``prepare_device_batch``."""
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.data.loader import ARRAY_DTYPES
    from tricolo_tpu_torch.inference import prepare_inputs, to_device_batch
    from tricolo_tpu_torch.models.tricolo_net import TriCoLoNet

    keys = ("clip_embeddings_img", "clip_embeddings_text")
    assert all(ARRAY_DTYPES[k] == np.float32 for k in keys)
    ref = host_batch(jax_cfg(CLIP_TRI))
    dm = DataModule(torch_cfg(CLIP_TRI))
    dm.setup("test")
    batch = dm.test_loader().peek()
    assert "images" not in batch
    for key in keys:
        assert batch[key].dtype == np.float32 and batch[key].shape == (2, 768)
        np.testing.assert_array_equal(batch[key], ref[key])
    device_batch = to_device_batch(batch, CPU)
    inputs = prepare_inputs(TriCoLoNet.from_config(torch_cfg(CLIP_TRI)), device_batch)
    for key in keys:
        assert device_batch[key].dtype == torch.float32
        assert torch.equal(inputs[key], torch.from_numpy(ref[key]))


# ------------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def servers(clip_tri):
    """The JAX and the port CLIP-text servers on the same weights, both
    with the stub backend, indexes built."""
    import jax.numpy as jnp

    from tricolo_tpu.data import DataModule as JaxDataModule
    from tricolo_tpu.serving import RetrievalServer as JaxServer
    from tricolo_tpu.training.optim import make_optimizer
    from tricolo_tpu.training.state import TrainState
    from tricolo_tpu_torch.data import DataModule
    from tricolo_tpu_torch.serving import RetrievalServer

    _, params, stats = clip_tri
    # The JAX server shards its batches over the 8 virtual CPU devices.
    overrides = [*CLIP_TRI, "data.batch_size=8"]
    cfg = jax_cfg(overrides)
    state = TrainState.create({"params": jax.tree.map(jnp.asarray, params),
                               "batch_stats": jax.tree.map(jnp.asarray, stats)},
                              make_optimizer(cfg))
    ref = JaxServer(cfg, state, clip_backend=StubBackend())
    ref.build_index(JaxDataModule(cfg))
    ours = RetrievalServer(torch_cfg(overrides), port_model(params, stats, overrides),
                           device="cpu", clip_backend=StubBackend())
    ours.build_index(DataModule(torch_cfg(overrides)))
    return ours, ref


QUERIES = [[49406, 320, 1901, 4159, 49407], [49406, 7, 3000, 49407], list(range(1, 90))]


@pytest.mark.parametrize("tokens", QUERIES, ids=["short", "other", "over_77"])
def test_server_token_query_matches_jax(servers, tokens):
    ours, ref = servers
    assert ours.max_tokens == ref.max_tokens == 77
    assert ours.index.model_ids == ref.index.model_ids
    np.testing.assert_allclose(ours.index.matrix, ref.index.matrix, rtol=0, atol=1e-4)
    got, want = ours.query(tokens=tokens, k=5), ref.query(tokens=tokens, k=5)
    assert [m for m, _ in got] == [m for m, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-5)


def test_server_text_query_matches_jax(servers, tiny_bpe):
    ours, ref = servers
    got, want = ours.query(text="hello world", k=3), ref.query(text="hello world", k=3)
    assert [m for m, _ in got] == [m for m, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-5)


def test_server_text_query_without_bpe_raises(servers, monkeypatch):
    ours, _ = servers
    monkeypatch.delenv("TRICOLO_CLIP_BPE", raising=False)
    monkeypatch.setattr(ours, "clip_tokenizer", None)
    with pytest.raises(FileNotFoundError, match="BPE"):
        ours.query(text="a gray swivel chair")


def test_server_refuses_image_queries_and_needs_a_backend(servers):
    """``query_image`` with the CLIP image head raises, as the JAX server
    does; without an injected backend the server builds the transformers
    one from ``model.modules.clip_model``, which must be a local directory."""
    from tricolo_tpu_torch.serving import RetrievalServer

    ours, ref = servers
    for server in (ours, ref):
        with pytest.raises(NotImplementedError, match="MVCNN"):
            server.query_image(np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(FileNotFoundError, match="local CLIP checkpoint directory"):
        RetrievalServer(torch_cfg(CLIP_TRI), ours.model, device="cpu")


_BACKEND_SCRIPT = r"""
import os, sys
os.environ["HF_HUB_OFFLINE"] = "1"  # a local directory only: never the hub
os.environ["TRANSFORMERS_OFFLINE"] = "1"
import numpy as np
import torch
from transformers import CLIPConfig, CLIPModel

path = sys.argv[1]
torch.manual_seed(0)
config = CLIPConfig(
    text_config=dict(vocab_size=600, hidden_size=32, intermediate_size=64,
                     num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=77),
    vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2, image_size=32, patch_size=8),
    projection_dim=16)
CLIPModel(config).save_pretrained(path)

from tricolo_tpu.clip.extract import TransformersClipBackend as JaxBackend
from tricolo_tpu_torch.clip.extract import TransformersClipBackend

rng = np.random.default_rng(0)
pixels = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
tokens = np.zeros((2, 77), np.int32)
tokens[:, :5] = rng.integers(1, 599, (2, 5))
ours, ref = TransformersClipBackend(path), JaxBackend(path)
for name, x in (("encode_image", pixels), ("encode_text", tokens)):
    got, want = getattr(ours, name)(x), getattr(ref, name)(x)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(x), 16), name
    assert np.array_equal(got, want), name
print("backends equal")
"""


def test_transformers_backend_equals_jax_on_a_local_checkpoint(tmp_path):
    """A tiny random CLIP saved to a local directory (offline: the hub is
    never asked), read by both packages' ``TransformersClipBackend``: the
    same image and text features. In a subprocess, so the offline switches
    are set before ``transformers`` is first imported."""
    import os
    import subprocess
    import sys

    pytest.importorskip("transformers")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, os.environ.get("PYTHONPATH", "").split(os.pathsep))]),
        JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _BACKEND_SCRIPT, str(tmp_path / "clip")],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "backends equal" in proc.stdout
