"""The index-open pieces of the PyTorch port against the JAX package: the
columnar ``.meta.npz`` metadata sidecar, ``UnifiedIndex.compact`` and the
portable package.

- A sidecar written by either package opens in the other: the same arrays
  in the file, the same records (rows with ``tags``/``extra`` read their
  container blob), the same ``LazyRowByKey`` lookups, and the same hits as
  the record-by-record open.
- ``compact`` on a container with tombstones leaves the same rows (bit for
  bit), ids, metadata, thumbnails, journal, maps, build info and stats as
  the JAX ``compact`` on a copy, for bf16 rows and for int8 rows with the
  bf16 copy (``keep_fp``); both then answer the same queries (bf16:
  tie-aware, atol 5e-4; int8: bit for bit).
- A portable package exported by one package loads in the other.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.index import metacols as jmetacols
from intelligent_video_analysis_retrieval_system_tpu.index.container import (
    IndexContainer as JaxContainer,
)
from intelligent_video_analysis_retrieval_system_tpu.index.portable import (
    PortableIndex as JaxPortable,
)
from intelligent_video_analysis_retrieval_system_tpu.index.unified import (
    UnifiedIndex as JaxIndex,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index import metacols
from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import (
    IndexContainer,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.portable import PortableIndex
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    EnhancedRetrievalSystem,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import tie_aware_equal
from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

torch.set_num_threads(2)

N_BIG, DIM = 10_400, 32        # above SIDECAR_MIN_ROWS
BLOB_ROWS = (7, 5000, 10_399)  # records that carry tags/extra


def _record(i: int) -> dict:
    rec = {"folder": f"video_{i // 700:02d}", "image": f"{i % 700:05d}.jpg",
           "frame_id": (i % 700) * 12, "row_id": i, "pts_time": (i % 700) / 2.0, "fps": 25.0,
           "path": f"/data/keyframes/video_{i // 700:02d}/{i % 700:05d}.jpg"}
    if i in BLOB_ROWS:
        rec["tags"] = ["night", f"t{i}"]
        rec["extra"] = {"camera": i}
    return rec


def _write_big(path):
    rows = np.random.default_rng(0).standard_normal((N_BIG, DIM)).astype(np.float32)
    with JaxContainer(path, "w", dim=DIM, dtype="bfloat16") as c:
        c.append_embeddings(rows)
        c.append_metadata([_record(i) for i in range(N_BIG)])
        c.flush_checkpoint()
    return rows


def _sidecar(path):
    return path.with_name(path.name + ".meta.npz")


def _open(package: str, path):
    if package == "jax":
        return JaxIndex().load_unified_index(path)
    return UnifiedIndex(device="cpu").load_unified_index(path)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_sidecar_written_by_one_package_opens_in_the_other(tmp_path, writer, reader):
    a, b = tmp_path / "a.rvdb", tmp_path / "b.rvdb"
    _write_big(a)
    first = _open(writer, a)              # record by record, then writes the sidecar
    assert isinstance(first._metadata, list) and _sidecar(a).is_file()
    shutil.copy(a, b)
    shutil.copy(_sidecar(a), _sidecar(b))
    second = _open(reader, b)
    cols = {"jax": jmetacols, "torch": metacols}[reader]
    assert isinstance(second._metadata, cols.ColumnarMetadata)
    assert isinstance(second._row_by_key, cols.LazyRowByKey)
    assert len(second._metadata) == N_BIG
    for i in (0, 1, 699, 700, 4242, *BLOB_ROWS):
        assert second.get_metadata(i).to_dict() == first.get_metadata(i).to_dict()
        assert second.get_metadata(i).to_dict()["row_id"] == i
    assert second.get_metadata(5000).tags == ["night", "t5000"]
    assert [m.to_dict() for m in second._metadata[690:710]] == \
        [m.to_dict() for m in first._metadata[690:710]]
    assert second.row_for("video_07", "00100.jpg") == first.row_for("video_07", "00100.jpg") \
        == 7 * 700 + 100
    assert second.row_for("video_99", "nope.jpg") is None
    assert len(second._row_by_key) == N_BIG
    first.close()
    second.close()


def test_both_packages_write_the_same_sidecar(tmp_path):
    a, b = tmp_path / "a.rvdb", tmp_path / "b.rvdb"
    _write_big(a)
    shutil.copy(a, b)
    _open("jax", a).close()
    _open("torch", b).close()
    with np.load(_sidecar(a)) as za, np.load(_sidecar(b)) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


def test_sidecar_route_answers_as_the_record_route(tmp_path):
    path = tmp_path / "a.rvdb"
    _write_big(path)
    q = np.random.default_rng(1).standard_normal((4, DIM)).astype(np.float32)
    records = UnifiedIndex(device="cpu").load_unified_index(path, mode="a")
    want = records.search_vectors(q, top_k=10)
    records.close()
    index = UnifiedIndex(device="cpu").load_unified_index(path, mode="a")
    assert isinstance(index._metadata, metacols.ColumnarMetadata)
    got = index.search_vectors(q, top_k=10, filter_fn=lambda m: m.folder != "video_03")
    assert all(h.metadata.folder != "video_03" for hits in got for h in hits)
    got = index.search_vectors(q, top_k=10)
    assert [[(h.metadata.to_dict(), h.similarity_score) for h in hits] for hits in got] == \
        [[(h.metadata.to_dict(), h.similarity_score) for h in hits] for hits in want]
    # an append lands in the overlay and unlinks the now stale sidecar
    new = np.random.default_rng(2).standard_normal((3, DIM)).astype(np.float32)
    index.incremental_update(new, [{"folder": "late", "image": f"{i}.jpg", "frame_id": i}
                                   for i in range(3)])
    assert not _sidecar(path).exists()
    assert len(index._metadata) == N_BIG + 3 and index.row_for("late", "2.jpg") == N_BIG + 2
    assert index.get_metadata(N_BIG + 1).folder == "late"
    assert index.search(new[1], top_k=1)[0].metadata.row_id == N_BIG + 1
    index.close()


def test_facade_walks_a_columnar_sidecar_without_copying_it(tmp_path, monkeypatch):
    path = tmp_path / "a.rvdb"
    _write_big(path)
    UnifiedIndex(device="cpu").load_unified_index(path).close()   # writes the sidecar
    system = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=tmp_path),
        embedder=CLIPEmbedder(config=CLIPConfig.tiny_test(), device="cpu"), device="cpu")
    seen = []
    build = system.metadata.build_metadata
    monkeypatch.setattr(system.metadata, "build_metadata",
                        lambda metas, *a, **k: (seen.append(metas), build(metas, *a, **k)))
    system.load_system(path)
    assert isinstance(system.index._metadata, metacols.ColumnarMetadata)
    assert seen[0] is system.index._metadata          # no list(...) copy
    assert system.metadata.count() == N_BIG
    system.cleanup()


# ---------------------------------------------------------------------------
# compact
# ---------------------------------------------------------------------------

N_SMALL = 3000


def _write_small(path, dtype: str, keep_fp: bool = False):
    rows = np.random.default_rng(3).standard_normal((N_SMALL, DIM)).astype(np.float32)
    rows[500] = rows[20]   # a duplicated row: an exact tie in int8
    with JaxContainer(path, "w", dim=DIM, dtype=dtype, keep_fp=keep_fp) as c:
        c.append_embeddings(rows)
        c.append_metadata([_record(i) for i in range(N_SMALL)])
        c.append_thumbnails([b"thumb%d" % i for i in range(N_SMALL)])
        c.append_images([b"image%d" % i for i in range(N_SMALL)])
        c.append_journal([f"hash{i:04d}" for i in range(N_SMALL)])
        c.put_map("video_00", "n,pts_time,fps,frame_idx\n0,0.0,25.0,0\n")
        c.put_system("build", {"model": "tiny", "rows": N_SMALL})
        c.flush_checkpoint()
    return rows


def _container_dump(path, container_cls) -> dict:
    with container_cls(path, "r") as c:
        out = {
            "stats": {k: v for k, v in c.stats().as_dict().items()
                      if k not in ("path", "file_bytes")},
            "metadata": list(c.iter_metadata()),
            "thumbs": c.read_blob_range("thumbnails", 0, c.num_thumbnails),
            "images": c.read_blob_range("images", 0, c.num_images),
            "journal": sorted(c.journal_hashes()),
            "maps": {f: c.get_map(f) for f in c.map_folders()},
            "build": c.get_system("build"),
            "deleted": sorted(c.deleted_rows()),
        }
        if c.dtype == "int8":
            q, s = c.read_quantized()
            out["rows"] = (q.tobytes(), s.tobytes())
            if c.has_fp_rows:
                out["fp"] = c.read_fp_bits(0, c.num_rows).tobytes()
        else:
            out["rows"] = c.read_embeddings(0, c.num_rows).tobytes()
    return out


@pytest.mark.parametrize("dtype,keep_fp", [("bfloat16", False), ("int8", True)])
def test_compact_matches_jax(tmp_path, dtype, keep_fp):
    a, b = tmp_path / "a.rvdb", tmp_path / "b.rvdb"
    _write_small(a, dtype, keep_fp)
    shutil.copy(a, b)
    j = JaxIndex().load_unified_index(a, mode="a")
    t = UnifiedIndex(device="cpu").load_unified_index(b, mode="a")
    dead = [0, 19, 20, 300, 301, 302, N_SMALL - 1]
    assert t.delete_rows(dead) == j.delete_rows(dead)
    for suffix in (".flat", ".flat8", ".meta.npz"):   # stale sidecars must go
        b.with_name(b.name + suffix).write_bytes(b"stale")
    jout, tout = j.compact(), t.compact()
    assert {k: v for k, v in tout.items() if k != "path"} == \
        {k: v for k, v in jout.items() if k != "path"} == \
        {"compacted": len(dead), "ntotal": N_SMALL - len(dead)}
    assert tout["path"] == str(b)
    assert not any(b.with_name(b.name + s).exists() for s in (".flat", ".meta.npz", ".compact"))
    assert t.ntotal == j.ntotal == N_SMALL - len(dead) and t.num_deleted == 0
    # the rows that were 1 and 500 are now 0 and 500 - 3... by the same remap in both
    assert t.get_metadata(0).image == j.get_metadata(0).image == "00001.jpg"
    assert t.row_for("video_00", "00500.jpg") == j.row_for("video_00", "00500.jpg") == 494
    q = np.random.default_rng(4).standard_normal((5, DIM)).astype(np.float32)
    for jh, th in zip(j.search_vectors(q, top_k=10), t.search_vectors(q, top_k=10)):
        ji = np.array([h.metadata.row_id for h in jh])
        js = np.array([h.similarity_score for h in jh], np.float32)
        ti = np.array([h.metadata.row_id for h in th])
        ts = np.array([h.similarity_score for h in th], np.float32)
        tie_aware_equal(ti, ts, ji, js, atol=0.0 if dtype == "int8" else 5e-4)
    # a compacted index is writable again in the mode it was opened in
    assert t._container.mode == "a"
    j.close()
    t.close()
    assert _container_dump(b, IndexContainer) == _container_dump(a, JaxContainer)


def test_compact_to_another_path_and_without_tombstones(tmp_path):
    path, out = tmp_path / "a.rvdb", tmp_path / "out.rvdb"
    _write_small(path, "bfloat16")
    index = UnifiedIndex(device="cpu").load_unified_index(path, mode="a")
    assert index.compact() == {"compacted": 0, "ntotal": N_SMALL}
    index.delete_rows([5, 6])
    res = index.compact(out)
    assert res == {"compacted": 2, "ntotal": N_SMALL, "path": str(out)}   # source untouched
    assert index.num_deleted == 2
    index.close()
    with IndexContainer(out, "r") as c:
        assert c.num_rows == N_SMALL - 2 and not c.deleted_rows()
        assert c.get_metadata(5)["image"] == "00007.jpg"
        assert c.get_metadata(5)["row_id"] == 5
    with pytest.raises(RuntimeError):
        UnifiedIndex(device="cpu").compact()


def test_cli_compact(tmp_path, capsys):
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli

    path = tmp_path / "a.rvdb"
    _write_small(path, "int8", keep_fp=True)
    index = UnifiedIndex(device="cpu").load_unified_index(path, mode="a")
    index.delete_rows([1, 2, 3])
    index.close()
    assert cli.main(["compact", str(path), "--device", "cpu"]) == 0
    assert "compacted 3 tombstoned rows; 2997 live rows remain" in capsys.readouterr().out
    with IndexContainer(path, "r") as c:
        assert c.num_rows == 2997 and c.has_fp_rows
    with pytest.raises(RuntimeError):
        cli.main(["compact", str(path)])          # the default device is cuda


# ---------------------------------------------------------------------------
# portable packages
# ---------------------------------------------------------------------------


def _tiny_system(tmp_path):
    return EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=tmp_path),
        embedder=CLIPEmbedder(config=CLIPConfig.tiny_test(), device="cpu"), device="cpu")


def test_portable_package_exported_by_the_port_loads_in_jax(tmp_path):
    path = tmp_path / "a.rvdb"
    rows = _write_small(path, "bfloat16")
    system = _tiny_system(tmp_path)
    system.load_system(path)
    package = system.export_portable_index(tmp_path / "package")
    system.cleanup()
    manifest = json.loads((package / "manifest.json").read_text())
    assert manifest["format_version"] == "3.0" and manifest["index_file"] == "index.rvdb"
    exported = json.loads((package / "metadata.json").read_text())
    assert sum(len(v) for v in exported["folders"].values()) == N_SMALL
    assert JaxPortable().validate_package(package)["ok"]
    j = JaxPortable().load_package(package)
    assert j.ntotal == N_SMALL
    assert j.search(rows[33], top_k=1)[0].metadata.row_id == 33
    j.close()
    # the metadata export reads back in the port's manager
    fresh = _tiny_system(tmp_path / "other")
    fresh.metadata.load(package / "metadata.json")
    assert fresh.metadata.count() == N_SMALL


def test_portable_package_created_by_jax_loads_in_the_port(tmp_path):
    path = tmp_path / "a.rvdb"
    rows = _write_small(path, "int8", keep_fp=True)
    package = JaxPortable().create_package(path, tmp_path / "package", extra={"note": "x"})
    assert PortableIndex().validate_package(package) == JaxPortable().validate_package(package)
    with pytest.raises(RuntimeError):
        PortableIndex().load_package(package)                  # the default device is cuda
    index = PortableIndex().load_package(package, device="cpu")
    assert index.ntotal == N_SMALL and index._dev_scales is not None
    index.close()
    system = _tiny_system(tmp_path)
    system.load_portable_index(package)
    assert system.is_built and system.index.ntotal == N_SMALL
    assert system.index.search(rows[33], top_k=1)[0].metadata.row_id == 33
    assert system.metadata.count() == N_SMALL
    system.cleanup()
    # a torn transfer is refused by both
    (package / "index.rvdb").write_bytes(b"short")
    assert not PortableIndex().validate_package(package)["ok"]
    with pytest.raises(ValueError):
        PortableIndex().load_package(package, device="cpu")
    assert PortableIndex.to_portable_path("/mnt/x/keyframes/v1/3.jpg") == \
        JaxPortable.to_portable_path("/mnt/x/keyframes/v1/3.jpg") == "keyframes/v1/3.jpg"
