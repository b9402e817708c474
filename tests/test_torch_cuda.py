"""The CUDA kernels and the port's device paths on an NVIDIA card.

Marked `cuda`; each test skips without a card. On the card (JAX is not
needed there, so conftest.py is skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

gather_rows and scatter_add_rows must equal their plain versions bitwise,
and gather_rows stops with a device-side assert at an id outside its table
when the host does not check;
grouped_score_max agrees to atol 1e-4 (f32 sums in another order), in its
f32, bf16 and uint8 forms; the SQ, IVF and PQ searchers on the card agree
with their CPU runs to 1e-4;
rowwise_adagrad_update and sparse_adagrad_apply agree to 1 ulp of the table
type for p and rtol 1e-6 for acc (a row's mean is reduced in another order,
so acc may differ in its last bit and p by one rounding), untouched rows
bitwise, and rows whose gradient is all +0.0 are the only rows skipped;
the search and the model
agree with their CPU runs to 1e-5 and 2e-5. Ulps are measured at the larger
magnitude of the two values.

flash_attention agrees with its plain version within 1e-5 absolute in f32
(exps and sums in another order) and within 2^-6 * max|v| in bf16 (p is
rounded to bf16 before P.V, as the Pallas kernel does, and both outputs
round once more), at head dims past 128 too; the text encoder on the card
agrees with its CPU run within 2e-5 and launches flash_attention once per
layer and batch. The ranking models' eval outputs agree with their CPU runs
within 1e-5, and a Dcn split step's table update equals the plain update
(p bitwise, acc rtol 1e-6).

Training steps on the card agree with the same steps on the CPU; the GEMMs
and the duplicate sums add in another order on each device, so gradients
differ in their last bits:

  * losses rtol 1e-5;
  * f32 tables (three steps) rtol 1e-5 + atol 1e-6;
  * bf16 tables (one step; a flipped rounding compounds over later steps)
    within 1 ulp plus 2^-7 of the row's update: the "dense" strategies
    round the summed gradient to bf16 before the update, and a gradient
    that lands on the other side of a rounding moves the update by up to
    2^-8 of itself, which is several ulps of a result that nearly cancels;
  * the other float leaves rtol 1e-4 + atol 1e-5, except that at most 0.1%
    of a leaf's elements may differ by up to Adam's step (lr per step):
    Adam normalises each gradient by its own magnitude, so an element whose
    gradient is at the level of the summation noise takes a step of another
    size or sign on each device.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_parity as tp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# 64-, 128- and 512-byte rows in bf16 and f32 (16-byte words), f32 width 3
# and fp16 width 5 (4- and 2-byte words)
GATHER_WIDTHS = [(torch.float32, 16), (torch.float32, 32), (torch.float32, 128),
                 (torch.float32, 64), (torch.float32, 3), (torch.bfloat16, 32),
                 (torch.bfloat16, 64), (torch.bfloat16, 256),
                 (torch.float16, 5)]


@pytest.mark.parametrize("n", [1, 31, 33, 3001, 106496])
@pytest.mark.parametrize("dtype,width", GATHER_WIDTHS)
def test_gather_rows_kernel_bitwise(cuda, dtype, width, n):
    """Every N around a warp's 32 ids, up to a ranking batch's ids."""
    from recommendflow_tpu_torch.ops.cuda import embedding_bag
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((5000, width), generator=g, device=cuda).to(dtype)
    ids = torch.randint(0, 5000, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    before = embedding_bag.gather_rows.launches
    got = embedding_bag.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert embedding_bag.gather_rows.launches == before + 1
    assert torch.equal(got, embedding_bag.gather_rows_plain(table, ids))
    with pytest.raises(ValueError):
        embedding_bag.gather_rows(table, ids.long())


def _zipf_ids(n, rows, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(((rng.zipf(1.2, n) - 1) % rows).astype(np.int32))


@pytest.mark.parametrize("dtype,width", GATHER_WIDTHS)
def test_gather_rows_bitwise_on_zipf_ids(cuda, dtype, width):
    """Zipf(1.2) ids (hot rows repeated many times), bitwise."""
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as eb
    g = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn((7000, width), generator=g, device=cuda).to(dtype)
    ids = _zipf_ids(20_001, 7000, 2).to(cuda)
    got = eb.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8),
                       eb.gather_rows_plain(table, ids).view(torch.uint8))


@pytest.mark.parametrize("dtype,width", GATHER_WIDTHS)
def test_gather_rows_misaligned_view(cuda, dtype, width):
    """A table whose base pointer is one element past a 16-byte boundary (a
    sliced view) is copied in words smaller than 16 bytes, bitwise."""
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as eb
    g = torch.Generator(device=cuda).manual_seed(2)
    rows = 3000
    flat = torch.randn((rows * width + 1,), generator=g, device=cuda).to(dtype)
    table = flat[1:].view(rows, width)
    assert table.data_ptr() % 16 != 0
    ids = torch.randint(0, rows, (4099,), generator=g, device=cuda,
                        dtype=torch.int32)
    got = eb.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert eb._word_bytes(width * table.element_size(), table.data_ptr(),
                          got.data_ptr()) < 16
    assert torch.equal(got, eb.gather_rows_plain(table, ids))


@pytest.mark.parametrize("width", [32, 256])
def test_gather_rows_table_past_2gb(cuda, width):
    """A bf16 table of more than 2^31 bytes (64- and 512-byte rows), ids
    near its end and its start: the offsets are 64-bit."""
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as eb
    rows = (1 << 31) // (2 * width) + 4096
    table = torch.empty((rows, width), dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    table[-8192:] = torch.randn((8192, width), generator=g, device=cuda
                                ).to(torch.bfloat16)
    table[:64] = torch.randn((64, width), generator=g, device=cuda
                             ).to(torch.bfloat16)
    near_end = rows - 1 - torch.randint(0, 8192, (5000,), generator=g,
                                        device=cuda)
    ids = torch.cat([near_end, torch.arange(64, device=cuda)]).to(torch.int32)
    assert table.numel() * 2 > (1 << 31)
    got = eb.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16),
                       eb.gather_rows_plain(table, ids).view(torch.int16))
    del table


def test_gather_rows_checks_ids_before_launch(cuda):
    """An id outside [0, R) raises IndexError before the kernel is launched;
    with check_ids=False (ids checked on the host) it launches with no host
    check."""
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as eb
    table = torch.randn((5000, 32), device=cuda).to(torch.bfloat16)
    for bad in ([0, 5000], [-1, 3], [4999, 7, 1 << 30]):
        before = eb.gather_rows.launches
        with pytest.raises(IndexError):
            eb.gather_rows(table, torch.tensor(bad, dtype=torch.int32,
                                               device=cuda))
        assert eb.gather_rows.launches == before
    ids = torch.tensor([4999, 0], dtype=torch.int32, device=cuda)
    before = eb.gather_rows.launches
    got = eb.gather_rows(table, ids, check_ids=False)
    assert eb.gather_rows.launches == before + 1
    assert torch.equal(got, table[[4999, 0]])


_BAD_ID_ON_THE_CARD = textwrap.dedent("""
    import os, sys
    import torch
    sys.path.insert(0, sys.argv[1])
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import to_device
    conf = Configuration(sys.argv[2])
    model, _ = build_network(conf.networks["class"],
                             {"conf": conf, "device": "cuda", "seed": 0})
    batch = synthetic_batch(model.schema, 64, seed=1)
    batch[model.schema.sparse_slots()[0].name].reshape(-1)[3] = int(sys.argv[3])
    model.eval()
    try:
        with torch.no_grad():
            model.embedder(to_device(batch, torch.device("cuda")))
            print("launched", flush=True)
            torch.cuda.synchronize()
    except RuntimeError as e:
        print("raised:", e, flush=True)
        os._exit(0)
    print("no error", flush=True)
    os._exit(0)
""")


@pytest.mark.parametrize("bad", [1 << 30, -(1 << 30)])
def test_embed_pass_on_device_tensors_stops_at_a_bad_id(cuda, bad):
    """A batch put on the card by the caller is not checked on the host;
    an id outside the stacked table stops the embed pass's gather with a
    device-side assert before its row is read. The assert ends the CUDA
    context, so the pass runs in a process of its own."""
    root = os.path.abspath(tp.ROOT)
    r = subprocess.run(
        [sys.executable, "-c", _BAD_ID_ON_THE_CARD, root,
         os.path.join(root, "conf", "demo_ranking.yaml"), str(bad)],
        capture_output=True, text=True, timeout=300)
    said = r.stdout + r.stderr
    assert r.returncode == 0, said
    assert "raised:" in r.stdout and "no error" not in r.stdout, said
    assert "device-side assert" in said, said
    assert "gather_rows: id outside [0, rows) of the table" in said, said


@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("q,n_pad,d,group", [
    (37, 1024 + 64, 40, 16), (256, 4096, 128, 16), (5, 512, 7, 4),
    (130, 2048, 64, 64)])
def test_grouped_score_max_kernel(cuda, vec_dtype, l2, q, n_pad, d, group):
    from recommendflow_tpu_torch.ops.cuda import grouped_topk
    g = torch.Generator(device=cuda).manual_seed(1)
    qs = torch.randn((q, d), generator=g, device=cuda)
    v = torch.randn((n_pad, d), generator=g, device=cuda).to(vec_dtype)
    sqn = (v.float() ** 2).sum(1) if l2 else None
    num_items = n_pad - 3 * group // 2
    got = grouped_topk.grouped_score_max(qs, v, sqn, group=group,
                                         num_items=num_items)
    ref = grouped_topk.grouped_score_max_plain(qs, v, sqn, group=group,
                                               num_items=num_items)
    torch.cuda.synchronize()
    assert got.shape == (q, n_pad // group)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        grouped_topk.grouped_score_max(qs, v, sqn, group=12,
                                       num_items=num_items)


@pytest.mark.parametrize("group", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("q,n_pad,d", [(37, 1024 + 64, 40), (5, 3 * 64, 7),
                                       (130, 2048 + 192, 129), (256, 4096, 128)])
def test_grouped_score_max_uint8_kernel(cuda, group, l2, q, n_pad, d):
    """The uint8 (SQ8 code) form at odd shapes: D not a multiple of 16, N_pad
    not a multiple of 128, a masked tail, every group size. Queries of the
    size q ⊙ scale has (the codes reach 255), rounded to bf16 on both
    sides; atol 1e-4 for f32 sums in another order."""
    from recommendflow_tpu_torch.ops.cuda import grouped_topk
    g = torch.Generator(device=cuda).manual_seed(3)
    qs = torch.randn((q, d), generator=g, device=cuda) * 0.01
    codes = torch.randint(0, 256, (n_pad, d), generator=g, device=cuda,
                          dtype=torch.uint8)
    vmin = torch.randn((d,), generator=g, device=cuda) * 0.1
    xhat = vmin + 0.01 * codes.float()
    sqn = (xhat ** 2).sum(1) if l2 else None
    num_items = n_pad - 3 * group // 2
    before = dict(grouped_topk.grouped_score_max.launches_by_dtype)
    got = grouped_topk.grouped_score_max(qs, codes, sqn, group=group,
                                         num_items=num_items)
    ref = grouped_topk.grouped_score_max_plain(qs, codes, sqn, group=group,
                                               num_items=num_items)
    torch.cuda.synchronize()
    after = grouped_topk.grouped_score_max.launches_by_dtype
    assert after["uint8"] == before["uint8"] + 1
    assert after["float32"] == before["float32"]
    assert got.shape == (q, n_pad // group)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="not supported"):
        grouped_topk.grouped_score_max(qs, codes.to(torch.int8), sqn,
                                       group=group, num_items=num_items)


@pytest.mark.parametrize("qtype", ["sq8", "bf16"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_sq_searcher_card_matches_cpu(cuda, monkeypatch, qtype, metric):
    """The tournament path (forced on a small corpus) on the card against the
    same searcher on the CPU: the kernel's uint8 form (sq8) or bf16 form
    launched once per query block; scores within 1e-4, ids as sets."""
    from recommendflow_tpu_torch.ops.cuda import grouped_topk
    from recommendflow_tpu_torch.retrieval import _kernels
    from recommendflow_tpu_torch.retrieval.sq import SqSearcher
    monkeypatch.setattr(_kernels, "_HIER_MIN_ITEMS", 1024)
    rng = np.random.RandomState(4)
    vecs = rng.randn(30000, 96).astype(np.float32)
    qs = rng.randn(70, 96).astype(np.float32)
    form = "uint8" if qtype == "sq8" else "bfloat16"
    before = grouped_topk.grouped_score_max.launches_by_dtype[form]
    gpu = SqSearcher(96, metric, qtype=qtype, item_block=2048, query_block=32,
                     device=cuda).train(vecs)
    s_gpu, i_gpu = gpu.search(qs, 20, return_items=False)
    assert grouped_topk.grouped_score_max.launches_by_dtype[form] == before + 3
    cpu = SqSearcher(96, metric, qtype=qtype, item_block=2048, query_block=32,
                     device="cpu").train(vecs)
    assert torch.equal(gpu._codes.cpu(), cpu._codes)
    s_cpu, i_cpu = cpu.search(qs, 20, return_items=False)
    np.testing.assert_allclose(np.sort(s_gpu, 1), np.sort(s_cpu, 1), rtol=0,
                               atol=1e-4)
    assert np.mean([set(a) == set(b) for a, b in zip(i_gpu, i_cpu)]) >= 0.97


def test_ivf_and_pq_card_match_cpu(cuda, tmp_path):
    """IVF with the CPU's quantizer carried over, PQ and IVF-PQ from the
    CPU's saved state: the same top-k (scores within 1e-4)."""
    from recommendflow_tpu_torch.retrieval import (IvfPqSearcher, IvfSearcher,
                                                   PqSearcher)
    corpus, q = tp.clustered_world()
    cpu = IvfSearcher(32, "ip", nlist=32, nprobe=4, cap_factor=1.5,
                      device="cpu").train(corpus)
    gpu = IvfSearcher(32, "ip", nlist=32, nprobe=4, cap_factor=1.5,
                      device=cuda).train(corpus,
                                         centroids=cpu._centroids.numpy())
    tp.agree(cpu.search(q, 10, return_items=False),
             gpu.search(q, 10, return_items=False), 1e-4)
    for cls, kw in ((PqSearcher, dict(num_subspaces=8, item_block=512)),
                    (IvfPqSearcher, dict(nlist=16, nprobe=4, num_subspaces=8,
                                         cap_factor=1.2))):
        c = cls(32, "l2", device="cpu", **kw).train(corpus)
        c.save(str(tmp_path / "i.npz"))
        g = cls.load(str(tmp_path / "i.npz"), device=cuda)
        tp.agree(c.search(q, 10, return_items=False),
                 g.search(q, 10, return_items=False), 1e-4)


def test_flat_searcher_card_matches_cpu(cuda):
    from recommendflow_tpu_torch.ops.cuda import grouped_topk
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    rng = np.random.RandomState(0)
    vecs = rng.randn(262144 - 1000, 128).astype(np.float32)
    qs = rng.randn(50, 128).astype(np.float32)
    before = grouped_topk.grouped_score_max.launches
    _, s_gpu, i_gpu = FlatSearcher(128, "cos", device=cuda).train(vecs).search(qs, 100)
    assert grouped_topk.grouped_score_max.launches == before + 1
    _, s_cpu, i_cpu = FlatSearcher(128, "cos", device="cpu").train(vecs).search(qs, 100)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=0, atol=1e-5)
    assert (i_gpu == i_cpu).mean() > 0.99


def test_dssm_card_matches_cpu(cuda):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.ops.cuda import embedding_bag
    from recommendflow_tpu_torch.train.trainer import predict
    conf = Configuration(tp.DEMO_CONF)
    conf.networks["table_dtype"] = "bfloat16"
    gpu = Dssm(conf, device=cuda, seed=3)
    cpu = Dssm(conf, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batches = [synthetic_batch(gpu.schema, 64, seed=i) for i in range(3)]
    before = embedding_bag.gather_rows.launches
    a = predict(gpu, batches, cuda)
    assert embedding_bag.gather_rows.launches == before + 2 * 3   # two dim groups
    b = predict(cpu, batches, "cpu")
    for k in ("user", "ad"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-5)


def _ulps(a, b):
    """Largest |a - b| in units of the type's spacing at max(|a|, |b|)."""
    bits = 7 if a.dtype == torch.bfloat16 else 23
    a32, b32 = a.float(), b.float()
    mag = torch.maximum(a32.abs(), b32.abs()).clamp(min=2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    return float(((a32 - b32).abs() / spacing).max())


def _update_inputs(cuda, dtype, width, rows=3000, n=2500, seed=0):
    from recommendflow_tpu_torch.ops.cuda.embedding_bag import segment_row_grads
    g = torch.Generator(device=cuda).manual_seed(seed)
    p = torch.randn((rows, width), generator=g, device=cuda).to(dtype)
    acc = torch.rand((rows, 1), generator=g, device=cuda) + 0.1
    ids = torch.randint(0, rows - 500, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    grads = torch.randn((n, width), generator=g, device=cuda) * 0.01
    s_, order = torch.sort(ids, stable=True)
    summed, uid, _, n_valid = segment_row_grads(s_, grads[order], num_rows=rows)
    touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
    touched[ids.long()] = True
    return p, acc, uid, summed, n_valid, touched


WIDTHS = [(torch.bfloat16, 256), (torch.float32, 128), (torch.bfloat16, 64),
          (torch.float32, 12), (torch.bfloat16, 3)]


@pytest.mark.parametrize("dtype,width", WIDTHS)
def test_scatter_add_rows_kernel_bitwise(cuda, dtype, width):
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as k
    p, _, uid, summed, n_valid, _ = _update_inputs(cuda, dtype, width)
    got, ref = p.clone(), p.clone()
    before = k.scatter_add_rows.launches
    k.scatter_add_rows(uid, summed, got, n_valid)
    k.scatter_add_rows_plain(uid, summed, ref, n_valid)
    torch.cuda.synchronize()
    assert k.scatter_add_rows.launches == before + 1
    assert _ulps(got, ref) == 0
    # entries past n_valid are never applied
    short = p.clone()
    k.scatter_add_rows(uid, summed, short, torch.ones(1, dtype=torch.int32,
                                                      device=cuda))
    changed = (short != p).any(1).nonzero().flatten().tolist()
    assert changed == [int(uid[0])]
    with pytest.raises(ValueError):
        k.scatter_add_rows(uid, summed.to(torch.bfloat16), got, n_valid)
    with pytest.raises(ValueError):
        k.scatter_add_rows(uid.long(), summed, got, n_valid)


@pytest.mark.parametrize("dtype,width", WIDTHS)
def test_rowwise_adagrad_update_kernel(cuda, dtype, width):
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    from recommendflow_tpu_torch.ops.cuda import table_update as k
    p, acc, uid, summed, n_valid, touched = _update_inputs(cuda, dtype, width)
    gd = torch.zeros_like(p)
    kr.scatter_add_rows(uid, summed, gd, n_valid)
    p1, a1, p2, a2 = p.clone(), acc.clone(), p.clone(), acc.clone()
    before = k.rowwise_adagrad_update.launches
    k.rowwise_adagrad_update(p1, a1, gd, lr=0.05)
    k.rowwise_adagrad_update_plain(p2, a2, gd, lr=0.05)
    torch.cuda.synchronize()
    assert k.rowwise_adagrad_update.launches == before + 1
    assert _ulps(p1, p2) <= 1
    torch.testing.assert_close(a1, a2, rtol=1e-6, atol=0)
    assert torch.equal(p1[~touched], p[~touched])
    assert torch.equal(a1[~touched], acc[~touched])
    with pytest.raises(ValueError):
        k.rowwise_adagrad_update(p1, a1.view(-1), gd, lr=0.05)


@pytest.mark.parametrize("dtype,width", [(torch.float32, 64),
                                         (torch.bfloat16, 64),
                                         (torch.float32, 3)])
def test_rowwise_adagrad_update_skips_only_all_zero_rows(cuda, dtype, width):
    """Rows whose squares underflow to 0 (|g| ~ 1e-30) and rows of -0.0 are
    updated as the plain version updates them; only all-+0.0 rows are left
    alone. The p values are tiny and -0.0, where a skipped update shows."""
    from recommendflow_tpu_torch.ops.cuda import table_update as k
    g = torch.zeros((4, width), dtype=torch.float32, device=cuda)
    g[1, 0] = 1e-30                          # g^2 underflows, g does not
    g[2] = -0.0
    g[3] = torch.linspace(-1e-2, 1e-2, width, device=cuda)
    p = torch.full((4, width), 1e-31, dtype=torch.float32, device=cuda)
    p[:, 1:] = -0.0
    p, g = p.to(dtype), g.to(dtype)
    acc = torch.full((4, 1), 0.1, device=cuda)
    p1, a1, p2, a2 = p.clone(), acc.clone(), p.clone(), acc.clone()
    k.rowwise_adagrad_update(p1, a1, g, lr=0.05)
    k.rowwise_adagrad_update_plain(p2, a2, g, lr=0.05)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(p1.view(bits), p2.view(bits))
    assert torch.equal(a1, a2)
    assert torch.equal(p1[0].view(bits), p[0].view(bits))     # left alone
    assert not torch.equal(p1[1:3].view(bits), p[1:3].view(bits))


@pytest.mark.parametrize("dtype,width", WIDTHS)
def test_sparse_adagrad_apply_kernel(cuda, dtype, width):
    from recommendflow_tpu_torch.ops.cuda import sparse_apply as k
    p, acc, uid, summed, n_valid, touched = _update_inputs(cuda, dtype, width)
    p1, a1, p2, a2 = p.clone(), acc.clone(), p.clone(), acc.clone()
    before = k.sparse_adagrad_apply.launches
    k.sparse_adagrad_apply(p1, a1, uid, summed, n_valid, lr=0.05)
    k.sparse_adagrad_apply_plain(p2, a2, uid, summed, n_valid, lr=0.05)
    torch.cuda.synchronize()
    assert k.sparse_adagrad_apply.launches == before + 1
    assert _ulps(p1, p2) <= 1
    torch.testing.assert_close(a1, a2, rtol=1e-6, atol=0)
    assert torch.equal(p1[~touched], p[~touched])
    assert torch.equal(a1[~touched], acc[~touched])


@pytest.mark.parametrize("table_dtype,steps", [("float32", 3),
                                               ("bfloat16", 1)])
@pytest.mark.parametrize("mode,strategy", [("split", "dense"),
                                           ("split", "sparse_set"),
                                           ("dense", "dense")])
def test_train_steps_card_match_cpu(cuda, mode, strategy, table_dtype, steps):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    from recommendflow_tpu_torch.ops.cuda import sparse_apply as ks
    from recommendflow_tpu_torch.ops.cuda import table_update as kt
    from recommendflow_tpu_torch.train.trainer import Trainer
    conf = Configuration(tp.DEMO_CONF)
    conf.networks["table_dtype"] = table_dtype
    gpu = Dssm(conf, device=cuda, dropout=0.0, seed=3)
    cpu = Dssm(conf, device="cpu", dropout=0.0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batches = [synthetic_batch(gpu.schema, 64, seed=i) for i in range(steps)]
    start = {k: v.detach().clone() for k, v in cpu.state_dict().items()}
    counts =[f.launches for f in (kr.scatter_add_rows, kt.rowwise_adagrad_update,
                                   ks.sparse_adagrad_apply)]
    runs = {}
    for dev, model in ((cuda, gpu), ("cpu", cpu)):
        t = Trainer(model, table_update=mode, split_strategy=strategy, device=dev)
        state = t.init_state(batches[0])
        losses = [float(t.train_step(state, b)[1]["loss"]) for b in batches]
        runs[str(dev)] = (losses, {k: v.detach().cpu() for k, v in
                                   model.state_dict().items()})
    launched = [f.launches - c for f, c in zip(
        (kr.scatter_add_rows, kt.rowwise_adagrad_update, ks.sparse_adagrad_apply),
        counts)]
    n = 2 * steps                                   # two tables a step
    assert launched == ([0, 0, n] if strategy == "sparse_set" else [n, n, 0])
    (gl, gs), (cl, cs) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    lr = 1e-3                                       # the Trainer's default
    for k in cs:
        if "table_dim" in k and table_dtype == "bfloat16":
            a, b = gs[k].float(), cs[k].float()
            mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            step = (b - start[k].float()).abs()
            assert bool(((a - b).abs() <= ulp + 2 ** -7 * step).all()), k
        elif "table_dim" in k:
            torch.testing.assert_close(gs[k], cs[k], rtol=1e-5, atol=1e-6)
        elif gs[k].is_floating_point():
            diff = (gs[k] - cs[k]).abs()
            off = diff > 1e-5 + 1e-4 * cs[k].abs()
            assert int(off.sum()) <= 1e-3 * off.numel(), k
            assert float(diff.max()) <= 2 * lr * steps, k
        else:
            assert torch.equal(gs[k], cs[k]), k


@pytest.mark.parametrize("zipf", [0.0, 1.2])
@pytest.mark.parametrize("strategy", ["dense", "sparse_set"])
def test_dcn_split_step_matches_the_plain_update(cuda, strategy, zipf):
    """A Dcn step on the split path (demo_ranking, bf16 tables): its table
    update redone through the plain versions on the same row gradients,
    both under torch's deterministic algorithms (the duplicate sums then
    add in one order): p bitwise, acc within rtol 1e-6, untouched rows
    bitwise; the loss within rtol 1e-5 of the same step on the CPU."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.ranking.dcn import Dcn
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    from recommendflow_tpu_torch.ops.cuda import sparse_apply as ks
    from recommendflow_tpu_torch.ops.cuda import table_update as kt
    from recommendflow_tpu_torch.train.trainer import Trainer, table_params
    conf = Configuration(f"{tp.ROOT}/conf/demo_ranking.yaml")
    conf.networks["table_dtype"] = "bfloat16"
    gpu = Dcn(conf, dropout=0.0, device=cuda, seed=5)
    cpu = Dcn(conf, dropout=0.0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batch = synthetic_batch(gpu.schema, 256, seed=9, zipf=zipf)
    t = Trainer(gpu, table_update="split", split_strategy=strategy, device=cuda)
    state = t.init_state(batch)
    (d,) = t._split_dims
    p = table_params(gpu)[d].detach()
    acc = state.table_acc[f"dim{d}"]
    p0, acc0 = p.clone(), acc.clone()
    counts = [f.launches for f in (kr.scatter_add_rows, kt.rowwise_adagrad_update,
                                   ks.sparse_adagrad_apply)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, _, phys, rows = t._forward_backward(t._put(batch))
        state.optimizer.step()
        t._apply_table_updates(state, phys, rows)
        p_k, acc_k = p.clone(), acc.clone()
        p.copy_(p0), acc.copy_(acc0)
        s_, order = torch.sort(phys[d], stable=True)
        summed, uid, _, n_valid = kr.segment_row_grads(
            s_, rows[d].grad[order].float(), num_rows=p.shape[0])
        if strategy == "dense":
            gd = torch.zeros_like(p)
            kr.scatter_add_rows_plain(uid, summed, gd, n_valid)
            kt.rowwise_adagrad_update_plain(p, acc, gd, lr=t.table_lr)
        else:
            ks.sparse_adagrad_apply_plain(p, acc, uid, summed, n_valid,
                                          lr=t.table_lr)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    launched = [f.launches - c for f, c in zip(
        (kr.scatter_add_rows, kt.rowwise_adagrad_update, ks.sparse_adagrad_apply),
        counts)]
    assert launched == ([0, 0, 1] if strategy == "sparse_set" else [1, 1, 0])
    touched = torch.zeros(p.shape[0], dtype=torch.bool, device=cuda)
    touched[phys[d].long()] = True
    assert _ulps(p_k, p) == 0
    torch.testing.assert_close(acc_k, acc, rtol=1e-6, atol=0)
    assert torch.equal(p_k[~touched].view(torch.int16),
                       p0[~touched].view(torch.int16))
    assert torch.equal(acc_k[~touched], acc0[~touched])
    tc = Trainer(cpu, table_update="split", split_strategy=strategy, device="cpu")
    cpu_loss = tc.train_step(tc.init_state(batch), batch)[1]["loss"]
    np.testing.assert_allclose(float(loss.detach()), float(cpu_loss),
                               rtol=1e-5)


def test_ranking_models_card_match_cpu(cuda):
    """Every ranking model of the port on the card: eval outputs within
    1e-5 of the same weights on the CPU (f32 GEMMs, TF32 off, summed in
    another order), gather_rows launched once a batch."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import embedding_bag
    conf = Configuration(f"{tp.ROOT}/conf/demo_ranking.yaml")
    for name in ("dnn", "dcn", "deepfm", "xdeepfm", "cold", "mmoe", "essm",
                 "escm2"):
        gpu, _ = build_network(name, {"conf": conf, "device": cuda, "seed": 2})
        cpu, _ = build_network(name, {"conf": conf, "device": "cpu"})
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        batch = synthetic_batch(gpu.schema, 128, seed=1)
        before = embedding_bag.gather_rows.launches
        with torch.no_grad():
            a = gpu({k: v.to(cuda) for k, v in tp.to_torch(batch).items()})
            b = cpu(tp.to_torch(batch))
        assert embedding_bag.gather_rows.launches == before + 1, name
        assert sorted(a) == sorted(b), name
        for k in b:
            np.testing.assert_allclose(a[k].cpu().numpy(), b[k].numpy(),
                                       rtol=0, atol=1e-5, err_msg=f"{name} {k}")


FA_CASES = [  # (batch, heads, Lq, Lk, head dim): the chip_smoke.py shapes
    (256, 12, 64, 64, 64), (3, 2, 77, 200, 8), (3, 2, 77, 200, 16),
    (3, 2, 77, 200, 32), (3, 2, 77, 200, 64), (3, 2, 77, 200, 128),
    (2, 2, 130, 33, 64), (1, 1, 1, 1, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d", FA_CASES)
def test_flash_attention_kernel(cuda, dtype, b, h, lq, lk, d):
    from recommendflow_tpu_torch.ops.attention import merge_heads, split_heads
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    g = torch.Generator(device=cuda).manual_seed(lq * 1000 + d)
    # q, k, v as split_heads hands them over: strided [B, H, L, D] views
    q, kk, v = (split_heads(torch.randn((b, n, h * d), generator=g,
                                        device=cuda).to(dtype), h)
                for n in (lq, lk, lk))
    mask = torch.rand((b, lk), generator=g, device=cuda) < 0.7
    mask[:, 0] = True
    mask[0] = False                                  # every key masked
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * float(
        v.float().abs().max())
    for m in (mask, None):
        before = k.flash_attention.launches
        got = k.flash_attention(q, kk, v, m)
        ref = k.flash_attention_plain(q, kk, v, m)
        torch.cuda.synchronize()
        assert k.flash_attention.launches == before + 1
        assert got.dtype == dtype and got.shape == (b, h, lq, d)
        assert float((got.float() - ref.float()).abs().max()) <= tol
    # the output is the transpose of a contiguous [B, Lq, H, D] buffer
    merged = merge_heads(got)
    assert merged.data_ptr() == got.data_ptr() and merged.is_contiguous()


def test_flash_attention_all_masked_row_is_the_mean_of_v(cuda):
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    g = torch.Generator(device=cuda).manual_seed(5)
    q, kk, v = (torch.randn((2, 3, n, 32), generator=g, device=cuda)
                for n in (9, 200, 200))
    mask = torch.ones((2, 200), dtype=torch.bool, device=cuda)
    mask[1] = False
    out = k.flash_attention(q, kk, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[1], v[1].mean(dim=1, keepdim=True).expand(
        3, 9, 32), rtol=0, atol=1e-5)


def test_flash_attention_refusals(cuda):
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    q = torch.randn((2, 2, 8, 16), device=cuda)
    m = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        empty = torch.randn((1, 1, 4, 0), device=cuda)
        k.flash_attention(empty, empty, empty)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        k.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        h = q.half()
        k.flash_attention(h, h, h)
    with pytest.raises(ValueError, match="contiguous last dim"):
        t = q.transpose(2, 3)
        k.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="key mask"):
        k.flash_attention(q, q, q, m.int())
    with pytest.raises(ValueError, match="CUDA tensors"):
        k.flash_attention(q, q, q.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lk", [33, 200])
@pytest.mark.parametrize("d", [129, 192, 256, 512])
def test_flash_attention_wide_heads(cuda, dtype, lk, d):
    """Head dims past 128 run in 128-wide chunks (the last one ragged at 129
    and 192): the strided split_heads views, with and without a key mask
    (leading and trailing holes, a row with every key masked), the one-tile
    key count 33 and 200 keys over four 64-key steps, at the kernel's own
    tolerances."""
    from recommendflow_tpu_torch.ops.attention import split_heads
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    g = torch.Generator(device=cuda).manual_seed(lk * 1000 + d)
    b, h, lq = 3, 2, 70
    q, kk, v = (split_heads(torch.randn((b, n, h * d), generator=g,
                                        device=cuda).to(dtype), h)
                for n in (lq, lk, lk))
    mask = torch.ones((b, lk), dtype=torch.bool, device=cuda)
    mask[0] = False                                  # every key masked
    mask[1, :lk // 2] = False                        # a leading hole
    mask[2, lk // 2 + 1:] = False                    # a trailing hole
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * float(
        v.float().abs().max())
    for m in (mask, None):
        before = k.flash_attention.launches
        got = k.flash_attention(q, kk, v, m)
        ref = k.flash_attention_plain(q, kk, v, m)
        torch.cuda.synchronize()
        assert k.flash_attention.launches == before + 1
        assert got.dtype == dtype and got.shape == (b, h, lq, d)
        assert float((got.float() - ref.float()).abs().max()) <= tol


def test_text_encoder_wide_head_card_matches_cpu(cuda):
    """One head of 256 dims, which the JAX package takes: the encoder on the
    card within 1e-4 of the CPU."""
    from recommendflow_tpu_torch.encoder import TextEncoderService, Tokenizer
    from recommendflow_tpu_torch.encoder.synthetic import make_texts, make_vocab
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    vocab = make_vocab(3000)
    tok = Tokenizer({t: i for i, t in enumerate(vocab)})
    sizes = dict(max_len=64, batch_size=32, model_dim=256, num_layers=2,
                 num_heads=1, ffn_hidden=512)
    gpu = TextEncoderService(tok, device=cuda, seed=3, **sizes)
    cpu = TextEncoderService(tok, device="cpu", **sizes)
    cpu.model.load_state_dict({n: t.cpu() for n, t in
                               gpu.model.state_dict().items()})
    texts = make_texts(40, seed=4)
    before = k.flash_attention.launches
    a = gpu.encode(texts, normalize=False)
    assert k.flash_attention.launches == before + 2 * 2   # 2 layers, 2 batches
    b = cpu.encode(texts, normalize=False)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_sdpa_on_the_card_launches_the_kernel(cuda):
    from recommendflow_tpu_torch.ops import attention
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    g = torch.Generator(device=cuda).manual_seed(2)
    q, kk, v = (torch.randn((2, 5, 16), generator=g, device=cuda)
                for _ in range(3))
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], dtype=torch.bool,
                        device=cuda)
    before = k.flash_attention.launches
    got = attention.scaled_dot_product_attention(q, kk, v, mask)
    assert k.flash_attention.launches == before + 1
    ref = attention.scaled_dot_product_attention(q.cpu(), kk.cpu(), v.cpu(),
                                                 mask.cpu())
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="key masks only"):
        attention.scaled_dot_product_attention(
            q, kk, v, torch.ones((2, 5, 5), dtype=torch.bool, device=cuda))


def test_text_encoder_service_card_matches_cpu(cuda):
    from recommendflow_tpu_torch.encoder import TextEncoderService, Tokenizer
    from recommendflow_tpu_torch.encoder.synthetic import make_texts, make_vocab
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    vocab = make_vocab(3000)
    tok = Tokenizer({t: i for i, t in enumerate(vocab)})
    sizes = dict(max_len=64, batch_size=32, model_dim=64, num_layers=2,
                 num_heads=4, ffn_hidden=128)
    gpu = TextEncoderService(tok, device=cuda, seed=3, **sizes)
    cpu = TextEncoderService(tok, device="cpu", **sizes)
    cpu.model.load_state_dict({n: t.cpu() for n, t in
                               gpu.model.state_dict().items()})
    texts = make_texts(100, seed=4)
    before = k.flash_attention.launches
    a = gpu.encode(texts, normalize=False)
    assert k.flash_attention.launches == before + 2 * 4   # 2 layers, 4 batches
    b = cpu.encode(texts, normalize=False)
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


def _tc_inputs(cuda, vec_dtype, q, n_pad, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if vec_dtype == torch.uint8:
        qs = torch.randn((q, d), generator=g, device=cuda) * 0.01
        v = torch.randint(0, 256, (n_pad, d), generator=g, device=cuda,
                          dtype=torch.uint8)
        v[0] = 255                                 # the largest code
    else:
        qs = torch.randn((q, d), generator=g, device=cuda)
        v = torch.randn((n_pad, d), generator=g, device=cuda).to(vec_dtype)
    return qs, v


@pytest.mark.parametrize("vec_dtype", [torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("group", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("q,d", [(1, 7), (63, 40), (65, 128), (130, 129),
                                 (130, 256)])
def test_grouped_score_max_tensor_core_forms(cuda, vec_dtype, group, l2, q, d):
    """The bf16 tensor-core kernel of the bf16 and uint8 corpora at ragged
    shapes: Q not a multiple of 64, D not a multiple of 16 (and of 8), N_pad
    not a multiple of the 128-item tile, a masked tail, every group size;
    codes up to 255. atol 1e-4: the products are exact in f32 (queries
    rounded to bf16 on both sides), only the sums' order and rounding
    differ, and these scores stay below ~20."""
    from recommendflow_tpu_torch.ops.cuda import grouped_topk
    n_pad = 1024 + 192
    qs, v = _tc_inputs(cuda, vec_dtype, q, n_pad, d, seed=q * 1000 + d)
    sqn = (v.float() ** 2).sum(1) * (1e-4 if vec_dtype == torch.uint8 else 1) \
        if l2 else None
    num_items = n_pad - 3 * group // 2
    form = "uint8" if vec_dtype == torch.uint8 else "bfloat16"
    before = dict(grouped_topk.grouped_score_max.launches_by_dtype)
    got = grouped_topk.grouped_score_max(qs, v, sqn, group=group,
                                         num_items=num_items)
    ref = grouped_topk.grouped_score_max_plain(qs, v, sqn, group=group,
                                               num_items=num_items)
    torch.cuda.synchronize()
    after = grouped_topk.grouped_score_max.launches_by_dtype
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == form) for k in after}
    assert got.shape == (q, n_pad // group)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("vec_dtype", [torch.bfloat16, torch.uint8])
def test_grouped_score_max_tensor_core_at_search_magnitudes(cuda, vec_dtype):
    """Scores of 90-200, the magnitude of the quantized-search corpus's
    (bf16(q ⊙ scale) · codes): the tensor cores' f32 sums against the plain
    version's within the same atol 1e-4 (3.5 ulps of f32 at 128: the
    products are exact, only the sums' order and rounding differ)."""
    from recommendflow_tpu_torch.ops.cuda import grouped_topk
    g = torch.Generator(device=cuda).manual_seed(11)
    q, n_pad, d = 300, 1 << 16, 128
    if vec_dtype == torch.uint8:
        v = torch.randint(0, 256, (n_pad, d), generator=g, device=cuda,
                          dtype=torch.uint8)
        qs = torch.rand((q, d), generator=g, device=cuda) * 0.009 + 0.003
    else:
        v = (torch.rand((n_pad, d), generator=g, device=cuda) * 2.0
             ).to(vec_dtype)
        qs = torch.rand((q, d), generator=g, device=cuda) * 0.9 + 0.3
    got = grouped_topk.grouped_score_max(qs, v, None, group=16,
                                         num_items=n_pad - 5)
    ref = grouped_topk.grouped_score_max_plain(qs, v, None, group=16,
                                               num_items=n_pad - 5)
    torch.cuda.synchronize()
    real = ref > -1e29
    assert 60 <= float(ref[real].min()) and float(ref.max()) <= 260
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lk", [1, 64, 128, 129, 200])
@pytest.mark.parametrize("d", [8, 24, 64, 128])
def test_flash_attention_kernel_key_tiles(cuda, dtype, lk, d):
    """The one-pass tile (Lk <= 64 and <= 128) and the online 64-key steps
    (Lk > 128) against the plain version: masks with leading, middle and
    trailing holes (whole 64-key steps masked at Lk = 200), a batch row with
    every key masked, Lq not a multiple of 64."""
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    g = torch.Generator(device=cuda).manual_seed(lk * 100 + d)
    b, h, lq = 5, 3, 70
    q, kk, v = (torch.randn((b, h, n, d), generator=g, device=cuda).to(dtype)
                for n in (lq, lk, lk))
    mask = torch.ones((b, lk), dtype=torch.bool, device=cuda)
    mask[0] = False                                  # every key masked
    mask[1, :lk // 2] = False                        # a leading hole
    mask[2, lk // 3:2 * lk // 3] = False             # a middle hole
    mask[3, lk // 2 + 1:] = False                    # a trailing hole
    mask[4] = torch.rand((lk,), generator=g, device=cuda) < 0.5
    mask[4, -1] = True
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * float(
        v.float().abs().max())
    before = k.flash_attention.launches
    got = k.flash_attention(q, kk, v, mask)
    ref = k.flash_attention_plain(q, kk, v, mask)
    torch.cuda.synchronize()
    assert k.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, lq, d)
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("vec_dtype", [torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("q,d", [(300, 512), (200, 1024), (129, 1408),
                                 (300, 1536), (65, 1544), (130, 2052),
                                 (65, 4096), (300, 4096)])
def test_grouped_score_max_tensor_core_wide_rows(cuda, vec_dtype, q, d):
    """Wide rows: the query tile stays resident while it leaves room for the
    ring, and past that each ring stage carries its K-block of the query
    rows, for any D (1544 and 2052 are ragged for the 16-byte copies, 2052
    for the 64-dim K-blocks too). The queries are scaled so the scores have
    a standard deviation of ~2: the f32 sums of up to 4096 exact products
    then round well inside the same atol 1e-4."""
    from recommendflow_tpu_torch.ops.cuda import grouped_topk
    n_pad = 512 + 64
    qs, v = _tc_inputs(cuda, vec_dtype, q, n_pad, d, seed=d)
    qs = qs / qs[0].norm() * 2.0 / float(v.float().pow(2).mean().sqrt())
    before = grouped_topk.grouped_score_max.launches
    got = grouped_topk.grouped_score_max(qs, v, None, group=8,
                                         num_items=n_pad - 3)
    ref = grouped_topk.grouped_score_max_plain(qs, v, None, group=8,
                                               num_items=n_pad - 3)
    torch.cuda.synchronize()
    assert grouped_topk.grouped_score_max.launches == before + 1
    assert got.shape == (q, n_pad // 8)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
