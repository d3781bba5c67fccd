"""The port's multi-device search across processes, over gloo on the CPU.

The twin of ``tests/test_distributed_multiproc.py``'s
``test_two_process_sharded_search``: two processes join one process group
(``parallel.distributed.initialize_distributed``), each lays four CPU shards
on the mesh (eight in all), and each holds ONLY the rows of its own shards
(``host_row_range`` / ``make_global_sharded_array``). The sharded searches
(bf16 rows, int8 rows with their per-row scales and tombstones, and the
sharded IVF over one global state) merge across the processes and must
equal a single-process oracle in both: the port's single-device search over
the whole corpus, bit for bit. Each child has a timeout of its own.

Twelve thousand rows: the mesh pads rows to ``8 * TILE_N`` (16,384) and
splits them evenly, so the second process owns rows 8,192-11,999.

The twin of ``test_four_process_lifecycle_with_ann``: four processes of two
CPU shards each interleave load, append, delete and compact with dense and
sharded-IVF searches over host-local uploads, each phase held to a numpy
oracle and the IVF at full probe to the dense sweep; then the mesh-backed
``UnifiedIndex`` over the four processes (each opens its own copy of one
container) builds its IVF across them at load, and answers, appends and
deletes as a single-device index over the same container does, bit for bit.

The JAX file's maintenance race (``test_two_process_maintenance_race``) has
no twin: it races ``build_ann`` against an append that donates the
snapshotted buffer, and torch donates no buffer.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.skipif(not torch.distributed.is_available()
                                or not torch.distributed.is_gloo_available(),
                                reason="needs torch.distributed with gloo")

_CHILD = r'''
import sys

pid, port, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, repo)
import numpy as np
import torch

torch.set_num_threads(1)
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import ann
from intelligent_video_analysis_retrieval_system_tpu_torch.ops.quant import (
    pad_rows_int8, quantize_rows_int8, topk_search_int8,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import TILE_N, topk_search
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import MeshSpec, create_mesh
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.distributed import (
    host_row_range, initialize_distributed, is_multi_host, make_global_sharded_array,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_ann import (
    make_sharded_ivf, sharded_ivf_topk,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_search import (
    sharded_topk, sharded_topk_int8,
)

info = initialize_distributed(f"127.0.0.1:{port}", 2, pid)
assert info["process_count"] == 2 and info["process_index"] == pid, info
assert is_multi_host() and initialize_distributed() == info       # idempotent

mesh = create_mesh(MeshSpec(axis_names=("index",), shape=(8,)), devices=["cpu"] * 4)
assert mesh.process_ids.tolist() == [0] * 4 + [1] * 4, mesh.process_ids
n, d, k = 12_000, 32, 10
rng = np.random.default_rng(0)          # the same corpus seed in both: the oracle's
x = rng.standard_normal((n, d)).astype(np.float32)
x /= np.linalg.norm(x, axis=-1, keepdims=True)
q = x[[5, 9000, 11_999, 77]] + 0.01 * rng.standard_normal((4, d)).astype(np.float32)
q /= np.linalg.norm(q, axis=-1, keepdims=True)
qt = torch.from_numpy(q)
start, end = host_row_range(n, mesh)
assert (start, end) == ((0, 8192) if pid == 0 else (8192, n)), (start, end)

def local_only(arr):
    assert arr.shape[0] == 8 * 2048 and len(arr.shards) == 4
    assert arr.positions == ([0, 1, 2, 3] if pid == 0 else [4, 5, 6, 7])
    assert sum(s.shape[0] for s in arr.shards) == 4 * 2048       # this process's rows only

# --- bf16: this process hands over ONLY x[start:end] ---
X = make_global_sharded_array(x[start:end], n, mesh, dtype="bfloat16")
local_only(X)
got = sharded_topk(mesh, X, qt, k, n)
want = topk_search(torch.from_numpy(x).to(torch.bfloat16), qt.to(torch.bfloat16), k)
assert torch.equal(got.indices, want.indices), (got.indices, want.indices)
assert torch.equal(got.scores, want.scores)
assert got.indices[:3, 0].tolist() == [5, 9000, 11_999], got.indices[:, 0]

# --- int8 with per-row scales (quantized host-locally) and tombstones ---
lq, ls = quantize_rows_int8(x[start:end])
Xq = make_global_sharded_array(lq, n, mesh)
Xs = make_global_sharded_array(ls, n, mesh)
dead = {5, 9000, 8191, 8192}
mask = np.zeros((n, 1), np.int8)
mask[sorted(dead), 0] = 1
Xd = make_global_sharded_array(mask[start:end], n, mesh)
local_only(Xq)
got8 = sharded_topk_int8(mesh, Xq, Xs, qt, k, n, deleted_sharded=Xd)
fq, fs = pad_rows_int8(*quantize_rows_int8(x))
fmask = np.zeros((fq.shape[0], 1), np.int8)
fmask[:n] = mask
want8 = topk_search_int8(torch.from_numpy(fq), torch.from_numpy(fs), qt, k, n_valid=n,
                         deleted=torch.from_numpy(fmask))
assert torch.equal(got8.indices, want8.indices), (got8.indices, want8.indices)
assert torch.equal(got8.scores, want8.scores)
assert not set(got8.indices.reshape(-1).tolist()) & dead

# --- the sharded IVF: every process builds the same global state from the
# oracle's copy, partitions it onto the mesh and searches its own rows ---
Xf = make_global_sharded_array(x[start:end], n, mesh)
xf = torch.zeros((X.shape[0], d))
xf[:n] = torch.from_numpy(x)
state, _ = ann.build_ivf(xf, n_rows=n, nlist=64, kmeans_iters=4, seed=0)
sivf = make_sharded_ivf(mesh, "index", state, Xf.shard_rows)
assert len(sivf.bucket_ids) == 4
for nprobe in (8, 64):
    gota = sharded_ivf_topk(mesh, Xf, sivf, qt, k, nprobe=nprobe, n_valid=n)
    wanta = ann.ivf_topk(xf, state, qt, k, nprobe=nprobe, n_valid=n)
    assert torch.equal(gota.indices, wanta.indices), (nprobe, gota.indices, wanta.indices)
    assert torch.equal(gota.scores, wanta.scores)

torch.distributed.destroy_process_group()
print(f"MULTIHOST OK pid={pid}", flush=True)
'''


_CHILD4 = r'''
import shutil
import sys
import tempfile
from pathlib import Path

pid, port, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, repo)
import numpy as np
import torch

torch.set_num_threads(1)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import IndexContainer
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
    UnifiedIndex, UnifiedIndexConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.ops.ann import build_ivf, tail_append
from intelligent_video_analysis_retrieval_system_tpu_torch.ops.quant import quantize_rows_int8
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import MeshSpec, create_mesh
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.distributed import (
    host_row_range, initialize_distributed, make_global_sharded_array,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_ann import (
    make_sharded_ivf, sharded_ivf_topk,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_search import (
    sharded_topk, sharded_topk_int8,
)

info = initialize_distributed(f"127.0.0.1:{port}", 4, pid)
assert info["process_count"] == 4, info
mesh = create_mesh(MeshSpec(axis_names=("index",), shape=(8,)), devices=["cpu"] * 2)
d, n0, n_app, k = 32, 12_000, 2_000, 10
rng = np.random.default_rng(7)      # the same corpus seed in every process; each
                                    # one UPLOADS only its own rows
corpus = rng.standard_normal((n0 + n_app, d)).astype(np.float32)
corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
q = corpus[:4] + 0.01 * rng.standard_normal((4, d)).astype(np.float32)
qt = torch.from_numpy(q)


def upload_int8(rows, n):
    start, end = host_row_range(n, mesh)
    lq, ls = quantize_rows_int8(rows[start:end])
    return make_global_sharded_array(lq, n, mesh), make_global_sharded_array(ls, n, mesh)


def oracle_sets_int8(rows, queries, topk, dead=None):
    rows_i8, row_scales = quantize_rows_int8(rows)
    q_i8, q_s = quantize_rows_int8(queries)
    full = (q_i8.astype(np.int32) @ rows_i8.T.astype(np.int32)).astype(np.float32)
    full = full * row_scales[None, :] * q_s[:, None]
    if dead is not None:
        full[:, sorted(dead)] = -np.inf
    return [set(r.tolist()) for r in np.argsort(-full, axis=1)[:, :topk]]


def check_against_dense(Xq, Xs, sivf, n, nprobe, rows, dead_sharded=None, dead=None, b=4):
    dense = sharded_topk_int8(mesh, Xq, Xs, qt[:b], k, n, deleted_sharded=dead_sharded)
    ann = sharded_ivf_topk(mesh, Xq, sivf, qt[:b], k, nprobe=nprobe, n_valid=n,
                           deleted_sharded=dead_sharded, scales_sharded=Xs)
    want = oracle_sets_int8(rows, q[:b], k, dead)
    for i in range(b):
        assert set(dense.indices[i].tolist()) == set(ann.indices[i].tolist()) == want[i], i
        assert torch.equal(torch.sort(dense.scores[i]).values, torch.sort(ann.scores[i]).values)


# --- phase 1: host-local load, dense and IVF searches (B=4 and B=1) ---
Xq, Xs = upload_int8(corpus, n0)
assert sum(s.shape[0] for s in Xq.shards) == 2 * Xq.shard_rows      # own shards only
state, _ = build_ivf(torch.from_numpy(corpus[:n0]), n_rows=n0, nlist=16, kmeans_iters=3)
sivf = make_sharded_ivf(mesh, "index", state, Xq.shard_rows)
check_against_dense(Xq, Xs, sivf, n0, 16, corpus[:n0])
check_against_dense(Xq, Xs, sivf, n0, 16, corpus[:n0], b=1)
# --- phase 2: append (a host-local upload; the IVF tail carries the new ids) ---
n1 = n0 + n_app
Xq, Xs = upload_int8(corpus, n1)
state = tail_append(state, list(range(n0, n1)))
sivf = make_sharded_ivf(mesh, "index", state, Xq.shard_rows)
check_against_dense(Xq, Xs, sivf, n1, 16, corpus[:n1])
# --- phase 3: delete (host-local tombstone shards) ---
dead = set(range(0, n1, 37))
start, end = host_row_range(n1, mesh)
mask = np.zeros((end - start, 1), np.int8)
mask[[r - start for r in dead if start <= r < end], 0] = 1
Dead = make_global_sharded_array(mask, n1, mesh)
check_against_dense(Xq, Xs, sivf, n1, 16, corpus[:n1], dead_sharded=Dead, dead=dead)
# --- phase 4: compact (drop the tombstoned rows, remap, rebuild the IVF) ---
corpus = corpus[[r for r in range(n1) if r not in dead]]
n2 = len(corpus)
Xq, Xs = upload_int8(corpus, n2)
state, _ = build_ivf(torch.from_numpy(corpus), n_rows=n2, nlist=16, kmeans_iters=3, seed=1)
sivf = make_sharded_ivf(mesh, "index", state, Xq.shard_rows)
check_against_dense(Xq, Xs, sivf, n2, 16, corpus)
startc, endc = host_row_range(n2, mesh)
Xb = make_global_sharded_array(corpus[startc:endc], n2, mesh, dtype="bfloat16")
got = sharded_topk(mesh, Xb, qt.to(torch.bfloat16), k, n2)
want = torch.from_numpy(corpus).to(torch.bfloat16).float() @ qt.to(torch.bfloat16).float().T
for i in range(4):
    assert set(got.indices[i].tolist()) == set(torch.topk(want[:, i], k).indices.tolist()), i

# --- phase 5: the mesh-backed index across the four processes ---
work = Path(tempfile.mkdtemp())
for name in ("mesh.rvdb", "single.rvdb"):
    with IndexContainer(work / name, "w", dim=d, dtype="float32") as c:
        c.append_embeddings(corpus)
        c.append_metadata([{"folder": "v", "image": f"{i}.jpg", "frame_id": i, "row_id": i}
                           for i in range(n2)])
        c.flush_checkpoint()
cfg = dict(ann=True, ann_nlist=16, ann_nprobe=4, ann_target_recall=None)
meshed = UnifiedIndex(UnifiedIndexConfig(**cfg), device="cpu", mesh=mesh)
meshed.load_unified_index(work / "mesh.rvdb", mode="a")        # builds its IVF across ranks
single = UnifiedIndex(UnifiedIndexConfig(**cfg), device="cpu")
single.load_unified_index(work / "single.rvdb", mode="a")
assert meshed.ann_active and meshed._sharded.ann_active and len(meshed._sharded._x.shards) == 2
for a, b_ in zip(meshed._ann[:3], single._ann[:3]):
    assert torch.equal(a, b_)


def same(queries):
    got = [[(h.metadata.row_id, h.similarity_score) for h in hits]
           for hits in meshed.search_vectors(queries, top_k=k)]
    want = [[(h.metadata.row_id, h.similarity_score) for h in hits]
            for hits in single.search_vectors(queries, top_k=k)]
    assert got == want, (got, want)


qb = np.concatenate([q, corpus[100:104]])
same(q[:1])          # the IVF (B <= ann_max_batch)
same(qb)             # the dense sweep (B = 8)
new = rng.standard_normal((3, d)).astype(np.float32)
new /= np.linalg.norm(new, axis=1, keepdims=True)
for index in (meshed, single):
    index.incremental_update(new, [{"folder": "w", "image": f"n{i}.jpg", "frame_id": i}
                                   for i in range(3)])
    index.delete_rows([5, 9000, 13_000])
assert meshed._sharded.n_valid == n2 + 3
same(new[:1])
same(np.concatenate([qb, new[1:]]))
meshed.close()
single.close()
shutil.rmtree(work)
torch.distributed.destroy_process_group()
print(f"MULTIHOST4 OK pid={pid}", flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_procs(tmp_path, source: str, n_procs: int, needle: str, timeout: float) -> None:
    """Run ``source`` in ``n_procs`` processes of one gloo group, each with a
    timeout of its own; every one must exit 0 and print ``needle``."""
    child = tmp_path / "child.py"
    child.write_text(source)
    repo = str(Path(__file__).resolve().parent.parent)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(child), str(i), port, repo],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for i in range(n_procs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        assert f"{needle} pid={i}" in out, out[-3000:]


def test_two_process_sharded_search(tmp_path):
    _run_procs(tmp_path, _CHILD, 2, "MULTIHOST OK", timeout=120)


def test_four_process_lifecycle_with_ann(tmp_path):
    pytest.importorskip("h5py")       # each process writes its own container
    _run_procs(tmp_path, _CHILD4, 4, "MULTIHOST4 OK", timeout=180)
