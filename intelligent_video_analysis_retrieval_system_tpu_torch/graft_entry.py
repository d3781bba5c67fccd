"""Entry points of a whole-system check: the flagship forward step and a
multi-device dry run.

Port of the repository's ``__graft_entry__.py`` (the JAX package's):

- :func:`entry` returns ``(fn, example_args)``: the seeded CLIP ViT-L/14
  image tower in bf16 (f32 parameters) and four 224 x 224 images of zeros;
  ``fn`` runs ``encode_image`` and the f32 L2 normalize, the per-batch unit
  of index building. On a card every vision layer launches kernel B3 once.
- :func:`dryrun_multichip` runs one step of every sharded program on
  ``n_devices`` logical shards of one device, in one process as the JAX
  dry run does on its virtual CPU devices: the DP + TP training step, the
  bf16 and int8 sharded self-retrieval, the facade's whole sharded lifecycle
  certified stage by stage against a single-device oracle over the same
  container, and the sharded IVF. The lifecycle and IVF stages write
  containers, which need h5py. Training and search across processes are
  held by ``tests/test_torch_train_multiproc.py`` and
  ``tests/test_torch_distributed.py``.

Both default to ``"cuda"`` and raise where there is no card; ``"cpu"`` runs
the kernels' plain versions.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device: torch.device | str = "cuda") -> tuple[Callable, tuple[Any, torch.Tensor]]:
    """``(fn, (model, pixels))``: ``fn(model, pixels)`` is the ViT-L/14 image
    tower (bf16 activations, f32 parameters from ``seed=0``) on ``pixels``,
    then the f32 L2 normalize; ``pixels`` are zeros of ``(4, 224, 224, 3)``
    in bf16 on ``device``."""
    from .index.unified import resolve_device
    from .models.clip import CLIPConfig
    from .models.convert import empty_model, load_clip

    dev = resolve_device(device)
    cfg = CLIPConfig.vit_l_14()
    _, sd = load_clip(config=cfg, seed=0, device=dev)
    model = empty_model(cfg, dev, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True, assign=True)
    model.eval()
    size = cfg.vision.image_size
    pixels = torch.zeros((4, size, size, 3), dtype=torch.bfloat16, device=dev)

    def fn(model, pixels):
        with torch.inference_mode():
            out = model.encode_image(pixels).float()
            return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)

    return fn, (model, pixels)


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda") -> None:
    """Run ONE step of every sharded program on ``n_devices`` logical
    shards of ``device`` (tiny shapes); raises on any disagreement and
    prints one summary line."""
    from .index.unified import resolve_device
    from .models.clip import CLIPConfig
    from .models.tokenizer import load_tokenizer
    from .ops.quant import quantize_rows_int8
    from .parallel import CLIPTrainer, MeshSpec, ShardedIndexSearcher, create_mesh

    dev = resolve_device(device)
    devices = [dev] * n_devices

    # --- 1. full training step: DP over 'data', TP over 'model' ---
    model_par = 2 if n_devices % 2 == 0 else 1
    data_par = n_devices // model_par
    mesh = create_mesh(MeshSpec(axis_names=("data", "model"), shape=(data_par, model_par)),
                       devices=devices)
    trainer = CLIPTrainer(CLIPConfig.tiny_test(), mesh)
    params, opt_state = trainer.init(0)
    rng = np.random.default_rng(0)
    # batch must divide evenly over the data axis for any n_devices
    batch = data_par * max(2, -(-8 // data_par))
    pixels = rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 500, (batch, 16)).astype(np.int32)
    tokens[:, -1] = 511
    params, opt_state, metrics = trainer.train_step(params, opt_state, pixels, tokens)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    # --- 2. sharded index search: rows over 'index', one merge ---
    index_mesh = create_mesh(MeshSpec(axis_names=("index",), shape=(n_devices,)),
                             devices=devices)
    searcher = ShardedIndexSearcher(index_mesh, dtype=torch.float32)
    x = rng.standard_normal((512, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    searcher.load(x)
    top = searcher.search(x[:4], k=5).indices[:, 0].tolist()
    if top != [0, 1, 2, 3]:
        raise AssertionError(f"self-retrieval failed: {top}")

    # --- 3. int8 capacity mode on the same mesh (rows + scales sharded) ---
    xq, xs = quantize_rows_int8(x)
    q8 = ShardedIndexSearcher(index_mesh)
    q8.load_int8(xq, xs)
    top8 = q8.search(x[:4], k=5).indices[:, 0].tolist()
    if top8 != [0, 1, 2, 3]:
        raise AssertionError(f"int8 self-retrieval failed: {top8}")

    # --- 4. the whole sharded lifecycle at the facade level, bf16 + int8 ---
    stages = _lifecycle_dryrun(index_mesh, dev)

    # --- 5. the sharded IVF: equal to the single-device IVF and, at full
    # probing, to the dense sweep
    stages += _ann_dryrun(index_mesh, dev)

    # --- 6. which tokenizer would a default deployment run?
    # IVARS_CLIP_VOCAB points at a directory with merges.txt
    tok = load_tokenizer(os.environ.get("IVARS_CLIP_VOCAB"))
    print(
        f"dryrun_multichip ok: {n_devices} shards of {dev}, train loss={loss:.3f}, "
        f"sharded search self-retrieval exact (bf16 + int8 capacity mode); "
        f"tokenizer={tok.kind}"
        + (" (DEGRADED text semantics — set model.vocab_dir or "
           "IVARS_CLIP_VOCAB)" if tok.kind != "clip_bpe" else "")
        + "; lifecycle stages certified vs single-device oracle: "
        + " ".join(stages)
        + "; across processes: training (tests/test_torch_train_multiproc.py) and the "
        "search lifecycle with the IVF (tests/test_torch_distributed.py)",
        flush=True,
    )


def _lifecycle_dryrun(index_mesh, device: torch.device) -> list[str]:
    """Walk the whole sharded index lifecycle on the mesh for both storage
    dtypes, asserting exact equality with a single-device oracle after
    every mutation. Returns the list of certified stage names."""
    from PIL import Image

    from .index.unified import UnifiedIndex
    from .models.clip import CLIPConfig
    from .retrieval.results import KeyframeMetadata
    from .system.embedder import CLIPEmbedder
    from .system.facade import EnhancedRetrievalSystem, SearchOptions
    from .utils.config import Config

    dim = 32  # tiny_test projection_dim

    def oracle_results(meshed: UnifiedIndex, q, k):
        """Single-device search over the SAME open container (attach, don't
        re-open: two handles on one HDF5 file are not safe)."""
        oracle = UnifiedIndex(meshed.config, device=device)  # no mesh
        oracle.attach_container(meshed._container)
        out = [(h.metadata.row_id, round(h.similarity_score, 4))
               for h in oracle.search(q, top_k=k)]
        oracle._container = None  # shared handle — must not close it
        oracle.close()
        return out

    stages: list[str] = []

    def run_lifecycle(td: str, dtype: str) -> None:
        rng = np.random.default_rng(5)
        root = Path(td) / dtype
        root.mkdir()
        for f in range(2):
            folder = root / "keyframes" / f"vid{f}"
            folder.mkdir(parents=True)
            for n in range(6):
                arr = rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)
                Image.fromarray(arr).save(folder / f"{n}.jpg")
        (root / "map").mkdir()
        for f in range(2):
            lines = ["n,pts_time,fps,frame_idx"] + [
                f"{n},{n * 0.4},25,{n * 10}" for n in range(6)]
            (root / "map" / f"vid{f}.csv").write_text("\n".join(lines))
        cfg = Config(config_file=None, base_dir=root, create_dirs=True,
                     overrides={"index": {"chunk_size": 8, "dtype": dtype,
                                          "thumbnail_size": 32}})
        system = EnhancedRetrievalSystem(
            cfg,
            embedder=CLIPEmbedder(config=CLIPConfig.tiny_test(), compute_dtype="float32",
                                  device=device),
            device=device, mesh=index_mesh)
        system.build_system(root / "keyframes", map_dir=root / "map")
        index = system.index
        if index._sharded is None:
            raise AssertionError("index not sharded over the mesh")

        def check(stage: str, k: int = 6) -> list:
            q = rng.standard_normal(dim).astype(np.float32)
            got = [(h.metadata.row_id, round(h.similarity_score, 4))
                   for h in index.search(q, top_k=k)]
            want = oracle_results(index, q, k)
            if got != want:
                raise AssertionError(f"{dtype} {stage}: meshed {got} != oracle {want}")
            stages.append(f"{dtype}:{stage}")
            return got

        check("build+search")
        # the facade text-search path over the mesh must work too
        hits = system.search("a photo", SearchOptions(limit=3))
        if not (isinstance(hits, list) and hits):
            raise AssertionError("facade search empty")

        # in-place append: same searcher object, unchanged capacity
        searcher, cap = index._sharded, index._capacity
        new = rng.standard_normal((3, dim)).astype(np.float32)
        new /= np.linalg.norm(new, axis=-1, keepdims=True)
        index.incremental_update(
            new, [KeyframeMetadata(folder="vx", image=f"{i}.jpg", frame_id=i)
                  for i in range(3)])
        if index._sharded is not searcher or index._capacity != cap:
            raise AssertionError("small append must stay in place (no re-shard)")
        before = check("append_in_place")

        # delete: tombstoned rows leave results immediately
        victim = before[0][0]
        index.delete_rows([victim])
        after = check("delete_tombstone")
        if any(r == victim for r, _ in after):
            raise AssertionError("tombstone ignored")

        # compact: physically removes tombstones, remaps ids
        report = index.compact()
        if report["compacted"] != 1 or index.num_deleted != 0:
            raise AssertionError(f"compact: {report}, {index.num_deleted} deleted left")
        check("compact")

        # overflow append: exceeds padded capacity -> re-shard, and a
        # live tombstone must survive the re-shard
        victim2 = index.search(np.asarray(new[0], np.float32), top_k=1)[0].metadata.row_id
        index.delete_rows([victim2])
        cap = index._capacity
        big = rng.standard_normal((cap, dim)).astype(np.float32)   # past the capacity
        big /= np.linalg.norm(big, axis=-1, keepdims=True)
        index.incremental_update(
            big, [KeyframeMetadata(folder="vy", image=f"{i}.jpg", frame_id=i)
                  for i in range(cap)])
        if index._capacity <= cap:
            raise AssertionError("overflow did not re-shard")
        check("append_overflow_reshard")
        got2 = index.search(np.asarray(new[0], np.float32), top_k=3)
        if any(h.metadata.row_id == victim2 for h in got2):
            raise AssertionError("tombstone lost across overflow re-shard")
        stages.append(f"{dtype}:tombstone_survives_reshard")
        system.cleanup()

    with tempfile.TemporaryDirectory() as td:
        for dtype in ("bfloat16", "int8"):
            run_lifecycle(td, dtype)
    return stages


def _ann_dryrun(index_mesh, device: torch.device) -> list[str]:
    """Certify the sharded IVF mode (``parallel.sharded_ann``) on the mesh:
    built over the sharded rows, equal to the single-device IVF for the
    same persisted state, exact at full probing, batched equal to B=1, tail
    appends and tombstones. Returns certified stage names."""
    from .index.container import IndexContainer
    from .index.unified import UnifiedIndex, UnifiedIndexConfig

    stages: list[str] = []
    rng = np.random.default_rng(9)
    n, d, nlist = 1536, 32, 16
    centers = rng.standard_normal((24, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 24, n)] + (
        0.35 / d**0.5) * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(n, 3, replace=False)]

    def tie_aware(hits_lists):
        """(id set, sorted rounded scores) per query: the candidates and
        their scores, whatever the order of near-ties."""
        return [({h.metadata.row_id for h in hits},
                 tuple(sorted(round(h.similarity_score, 3) for h in hits)))
                for hits in hits_lists]

    def single_view(meshed, cfg):
        view = UnifiedIndex(UnifiedIndexConfig(**cfg), device=device)
        view.attach_container(meshed._container)
        if view._sharded is not None:
            raise AssertionError("the single-device view is sharded")
        return view

    def release(view):
        view._container = None  # shared handle — must not close it
        view.close()

    with tempfile.TemporaryDirectory() as td:
        for dtype in ("float32", "int8"):
            path = Path(td) / f"ann_{dtype}.rvdb"
            with IndexContainer(path, "w", dim=d, dtype=dtype) as c:
                c.append_embeddings(x)
                c.append_metadata([{"folder": "v", "image": f"{i}.jpg", "frame_id": i,
                                    "row_id": i} for i in range(n)])
                c.flush_checkpoint()
            cfg = dict(ann=True, ann_nlist=nlist, ann_nprobe=4)
            meshed = UnifiedIndex(UnifiedIndexConfig(**cfg), device=device,
                                  mesh=index_mesh).load_unified_index(path, mode="a")
            if not (meshed.ann_active and meshed._sharded.ann_active):
                raise AssertionError(f"{dtype}: sharded ANN inactive after mesh build")
            stages.append(f"ann:{dtype}:build_sharded")

            # the state persisted by the mesh build restores single-device:
            # results must match at the same nprobe (the build's recall
            # guard may have tuned the meshed index's)
            single = single_view(meshed, cfg)
            if not single.ann_active:
                raise AssertionError(f"{dtype}: the single-device view has no IVF")
            single.config.ann_nprobe = meshed.config.ann_nprobe
            got = tie_aware(meshed.search_vectors(q, top_k=8))
            want = tie_aware(single.search_vectors(q, top_k=8))
            if got != want:
                raise AssertionError(f"{dtype}: mesh ANN != single-device ANN")
            release(single)
            stages.append(f"ann:{dtype}:equals_single_device")

            # nprobe == nlist probes every bucket + tail: provably exact
            meshed.config.ann_nprobe = nlist
            got = tie_aware(meshed.search_vectors(q, top_k=8))
            want = tie_aware(meshed.search_vectors(q, top_k=8, exact=True))
            if got != want:
                raise AssertionError(f"{dtype}: full probe != dense sharded")
            meshed.config.ann_nprobe = 4
            stages.append(f"ann:{dtype}:full_probe_exact")

            # batched against one query at a time at nprobe=2, where the
            # probe sets of the queries barely overlap (B=3 pads to 4)
            for view_name in ("sharded", "single"):
                view = meshed if view_name == "sharded" else single_view(meshed, cfg)
                batched = tie_aware(view.search_vectors(q, top_k=8, nprobe=2))
                one_by_one = tie_aware([view.search_vectors(qi[None], top_k=8, nprobe=2)[0]
                                        for qi in q])
                if batched != one_by_one:
                    raise AssertionError(f"{dtype}/{view_name}: batched != B=1 at nprobe=2: "
                                         f"{batched} vs {one_by_one}")
                if view is not meshed:
                    release(view)
            stages.append(f"ann:{dtype}:batched_equals_b1")

            # appends land in the partitioned tails and are found at once
            new = rng.standard_normal((3, d)).astype(np.float32)
            new /= np.linalg.norm(new, axis=1, keepdims=True)
            meshed.incremental_update(new, [{"folder": "w", "image": f"n{i}.jpg",
                                             "frame_id": i} for i in range(3)])
            if not (meshed.ann_active and meshed._sharded.ann_active):
                raise AssertionError(f"{dtype}: the IVF went inactive on append")
            hits = meshed.search_vectors(new, top_k=1)
            if [h[0].metadata.row_id for h in hits] != [n, n + 1, n + 2]:
                raise AssertionError(f"{dtype}: appended rows not found: {hits}")
            stages.append(f"ann:{dtype}:tail_append")

            # tombstones mask ANN candidates immediately
            meshed.delete_rows([n, n + 1, n + 2])
            hits = meshed.search_vectors(new, top_k=3)
            if {h.metadata.row_id for hs in hits for h in hs} & {n, n + 1, n + 2}:
                raise AssertionError(f"{dtype}: tombstone leak")
            stages.append(f"ann:{dtype}:tombstone")
            meshed.close()
    return stages
