"""The port's artifact store (``kubeflow_tpu_torch/pipelines/artifacts.py``)
against the JAX package's on the CPU: the same ``cas://`` address and path
for the same bytes, each package reading a root the other wrote (blobs,
the named register, tree manifests and their materialization), immutable
versions, refused names, ``artifact_store_from_env``; and
``load_params("artifact://…")`` by digest, by ``name@version`` and by the
newest version giving the same bits as ``file://`` of the same port
checkpoint, while an orbax tree raises an error naming orbax."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from kubeflow_tpu.pipelines import artifacts as jart  # noqa: E402
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.models.decoder import init_decoder_params  # noqa: E402
from kubeflow_tpu_torch.pipelines import artifacts as tart  # noqa: E402
from kubeflow_tpu_torch.serve.storage import load_params  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

STORES = {"jax": jart.ArtifactStore, "port": tart.ArtifactStore}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


def _tree_dir(root) -> str:
    """A small directory tree with nested files and a shared shard."""
    d = os.path.join(root, "src")
    os.makedirs(os.path.join(d, "1", "sub"))
    for rel, data in (("1/a.bin", b"\x00\x01" * 50), ("1/sub/b.txt", b"b"),
                      ("1/sub/c.txt", b"\x00\x01" * 50), ("meta.json", b"{}")):
        with open(os.path.join(d, rel), "wb") as f:
            f.write(data)
    return d


@pytest.mark.parametrize("data", [b"", b"kv page", bytes(range(256)) * 9,
                                  b"T{not a manifest"],
                         ids=["empty", "short", "binary", "t-prefix"])
def test_same_address_and_path_for_the_same_bytes(data, tmp_path):
    j = jart.ArtifactStore(str(tmp_path / "j"))
    t = tart.ArtifactStore(str(tmp_path / "t"))
    uri = t.put_bytes(data)
    assert uri == j.put_bytes(data)
    assert os.path.relpath(t.path_for(uri), t.root) == \
        os.path.relpath(j.path_for(uri), j.root)
    assert t.is_tree(uri) is False and j.is_tree(uri) is False
    for name in ("SCHEME", "ARTIFACT_SCHEME", "ROOT_ENV", "_TREE_KEY",
                 "_MARKER"):
        assert getattr(tart, name) == getattr(jart, name), name


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax-to-port", "port-to-jax"])
def test_each_package_reads_the_other_s_root(writer, reader, tmp_path):
    root = str(tmp_path / "store")
    w, r = STORES[writer](root), STORES[reader](root)
    blob = w.put_bytes(b"a blob")
    value = w.put_value({"k": [1, 2, 3]})
    tree = w.put_tree(_tree_dir(str(tmp_path)))
    for v in ("1", "2", "10", "1.9", "1.10", "beta"):
        w.register("model", v, tree)
    w.register("data", "1", blob)
    assert r.get_bytes(blob) == b"a blob"
    assert r.get_value(value) == {"k": [1, 2, 3]}
    assert r.versions("model") == w.versions("model") == \
        ["1", "1.9", "1.10", "2", "10", "beta"]
    assert r.names() == ["data", "model"]
    assert r.lookup("model") == r.lookup("model", "beta") == tree
    assert r.resolve("artifact://model@2") == tree
    assert r.resolve("artifact://" + blob[len("cas://"):]) == blob
    assert r.describe("artifact://model") == w.describe("artifact://model")
    assert r.describe("artifact://data@1")["kind"] == "blob"
    assert r.is_tree(tree) and r.get_value(tree) == w.get_value(tree)
    dest = r.localize("artifact://model@1")
    assert dest == os.path.join(root, "trees", tree[len("cas://"):])
    for rel, want in (("1/a.bin", b"\x00\x01" * 50), ("1/sub/b.txt", b"b"),
                      ("meta.json", b"{}")):
        with open(os.path.join(dest, rel), "rb") as f:
            assert f.read() == want
    # The writer sees the reader's materialization as committed, and
    # re-publishing the materialized tree gives the same manifest.
    assert w.materialize_tree(tree) == dest
    assert w.put_tree(dest) == tree
    assert r.localize("artifact://data@1") == w.path_for(blob)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_versions_are_immutable_and_bad_names_refused(pkg, tmp_path):
    store = STORES[pkg](str(tmp_path))
    a, b = store.put_bytes(b"a"), store.put_bytes(b"b")
    assert store.register("m", "1", a) == "artifact://m@1"
    assert store.register("m", "1", a) == "artifact://m@1"   # same: no-op
    with pytest.raises(ValueError, match="immutable"):
        store.register("m", "1", b)
    assert store.lookup("m", "1") == a
    for name in ("../etc", "/abs", ".hidden", "a/b", "gc", "0" * 64, ""):
        with pytest.raises(ValueError):
            store.register(name, "1", a)
    for name in ("../etc", "/abs", "a/b"):
        with pytest.raises(ValueError):
            store.lookup(name)
        with pytest.raises(ValueError):
            store.versions(name)
    with pytest.raises(ValueError):
        store.register("m", "../2", a)
    with pytest.raises(ValueError):
        store.resolve("artifact://m@../1")
    with pytest.raises(ValueError):
        store.path_for("artifact://m@1")
    with pytest.raises(FileNotFoundError):
        store.register("m", "2", "cas://" + "f" * 64)
    with pytest.raises(FileNotFoundError, match="known versions"):
        store.lookup("m", "7")


def test_artifact_store_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv(tart.ROOT_ENV, raising=False)
    with pytest.raises(RuntimeError, match="KFTPU_ARTIFACT_ROOT"):
        tart.artifact_store_from_env()
    explicit = tart.artifact_store_from_env(str(tmp_path / "x"))
    assert explicit.root == str(tmp_path / "x")
    monkeypatch.setenv(tart.ROOT_ENV, str(tmp_path / "env"))
    assert tart.artifact_store_from_env().root == str(tmp_path / "env")
    assert tart.artifact_store_from_env(str(tmp_path / "x")).root == \
        str(tmp_path / "x")
    assert os.path.isdir(tmp_path / "env")


def _assert_trees_equal(a, b):
    fa, fb = T.flatten(a), T.flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def test_artifact_load_equals_file_load(tmp_path, monkeypatch):
    """A port checkpoint published as a tree (by the JAX store, registered
    as two versions) loads through ``artifact://`` by digest, by
    ``name@version`` and by the newest version with the bits ``file://``
    gives; the env root serves when no root is passed."""
    cfg = preset("tiny", dtype="float32")
    ckpt = tmp_path / "ckpt"
    gen = torch.Generator("cpu")
    v1 = init_decoder_params(gen.manual_seed(1), cfg)
    v2 = init_decoder_params(gen.manual_seed(2), cfg)
    CheckpointManager(str(ckpt)).save(1, {"params": v1, "step": 1})
    root = str(tmp_path / "store")
    jstore = jart.ArtifactStore(root)
    t1 = jstore.put_tree(str(ckpt))
    CheckpointManager(str(ckpt)).save(2, {"params": v2, "step": 2})
    t2 = jstore.put_tree(str(ckpt))
    jstore.register("llm", "1", t1)
    jstore.register("llm", "2", t2)
    want = load_params(f"file://{ckpt}", cfg, device="cpu")
    _assert_trees_equal(want, v2)
    for uri in ("artifact://" + t2[len("cas://"):], "artifact://llm@2",
                "artifact://llm"):
        got = load_params(uri, cfg, device="cpu", artifact_root=root)
        _assert_trees_equal(got, want)
    _assert_trees_equal(load_params("artifact://llm@1", cfg, device="cpu",
                                    artifact_root=root), v1)
    monkeypatch.setenv("KFTPU_ARTIFACT_ROOT", root)
    got16 = load_params("artifact://llm", preset("tiny", param_dtype="bfloat16"),
                        device="cpu")
    _assert_trees_equal(got16, T.map_tree(lambda t: t.to(torch.bfloat16), v2))


def test_orbax_tree_raises_naming_it(tmp_path):
    """The format boundary: an orbax checkpoint (the JAX package's
    ``file://`` format) published as a tree is refused by the port, by
    name, while the JAX ``load_params`` reads it."""
    import orbax.checkpoint as ocp
    from kubeflow_tpu.models import config as jconfig
    from kubeflow_tpu.models import decoder as jdec
    from kubeflow_tpu.serve import storage as jstorage

    jcfg = jconfig.preset("tiny", dtype="float32")
    jparams = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    ockpt = tmp_path / "orbax"
    with ocp.CheckpointManager(
            str(ockpt), item_handlers=ocp.StandardCheckpointHandler()) as mgr:
        mgr.save(1, args=ocp.args.StandardSave({"params": jparams}))
        mgr.wait_until_finished()
    root = str(tmp_path / "store")
    uri = "artifact://" + jart.ArtifactStore(root).put_tree(
        str(ockpt))[len("cas://"):]
    back = jstorage.load_params(uri, jcfg, artifact_root=root)
    np.testing.assert_array_equal(np.asarray(back["embed"]),
                                  np.asarray(jparams["embed"]))
    with pytest.raises(FileNotFoundError, match="orbax"):
        load_params(uri, preset("tiny", dtype="float32"), device="cpu",
                    artifact_root=root)
    with pytest.raises(FileNotFoundError, match="orbax"):
        load_params(f"file://{ockpt}", preset("tiny", dtype="float32"),
                    device="cpu")
    with pytest.raises(ValueError, match="not a tree artifact"):
        blob = tart.ArtifactStore(root).put_bytes(b"not a tree")
        load_params("artifact://" + blob[len("cas://"):],
                    preset("tiny", dtype="float32"), device="cpu",
                    artifact_root=root)
