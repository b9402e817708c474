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
(p bitwise, acc rtol 1e-6), as does a Que2Search step's on the dense table
path. Kernel 6 holds at SiameseEncoder's BERT-Base shape with trailing-pad
masks, forward and gradient; SiameseEncoder's and Pdm's gradients on the
card agree with the CPU's as the attention rankers' do. A Dssm run
preempted by SIGTERM, restored and resumed on the card equals the
uninterrupted run bit for bit (dropout 0.3, torch's deterministic
algorithms, so the duplicate sums add in one order).

A graphed train step holds its six phase markers (rf_span_gather to
rf_span_end) once per replay, in order, and its phases' busy time sums to
the replay's; an eager step launches them only under a profiler.

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
    _split_step_matches_the_plain_update(cuda, "dcn", strategy, zipf)


@pytest.mark.parametrize("strategy", ["dense", "sparse_set"])
def test_tabtransformer_split_step_matches_the_plain_update(cuda, strategy):
    """The same for a TabTransformer step (flash_attention forward and its
    backward on the path): the table update against the plain versions, the
    loss against the CPU."""
    _split_step_matches_the_plain_update(cuda, "tabtransformer", strategy, 0.0)


def _split_step_matches_the_plain_update(cuda, name, strategy, zipf):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    from recommendflow_tpu_torch.ops.cuda import sparse_apply as ks
    from recommendflow_tpu_torch.ops.cuda import table_update as kt
    from recommendflow_tpu_torch.train.trainer import Trainer, table_params
    conf = Configuration(f"{tp.ROOT}/conf/demo_ranking.yaml")
    conf.networks["table_dtype"] = "bfloat16"
    gpu, _ = build_network(name, {"conf": conf, "dropout": 0.0,
                                  "device": cuda, "seed": 5})
    cpu, _ = build_network(name, {"conf": conf, "dropout": 0.0,
                                  "device": "cpu"})
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
    # a full [B, Lq, Lk] mask (once refused here) takes the vanilla maths on
    # the card and launches no kernel 6
    full = torch.rand((2, 5, 5), generator=g, device=cuda) > 0.3
    full[..., 0] = True
    got = attention.scaled_dot_product_attention(q, kk, v, full)
    assert k.flash_attention.launches == before + 1
    ref = attention.scaled_dot_product_attention(q.cpu(), kk.cpu(), v.cpu(),
                                                 full.cpu())
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-5)


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


# the attention shapes of the ranking slice: TabTransformer at bench_ranking
# (no mask), Esim at demo width (key masks, an all-pad row), SelfAttention
FA_GRAD_CASES = [(2048, 4, 52, 52, 8, False), (64, 4, 12, 12, 16, True),
                 (16, 1, 20, 20, 32, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,masked", FA_GRAD_CASES)
def test_flash_attention_gradient_card_matches_cpu(cuda, dtype, b, h, lq, lk,
                                                   d, masked):
    """Kernel 6's gradient on the card (the kernel forward, the vanilla
    backward) against autograd through the plain version on the CPU, q, k
    and v the strided split_heads views: f32 within 1e-5 + 1e-5 relative
    (sums in another order), bf16 within 2^-6 of each gradient's largest
    magnitude (the forward's bf16 rounding of P and of the output, then one
    rounding of each gradient)."""
    from recommendflow_tpu_torch.ops.attention import split_heads
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    g = torch.Generator(device=cuda).manual_seed(b + lk)
    q, kk, v = (split_heads(torch.randn((b, n, h * d), generator=g,
                                        device=cuda).to(dtype), h)
                for n in (lq, lk, lk))
    go = torch.randn((b, h, lq, d), generator=g, device=cuda).to(dtype)
    mask = None
    if masked:
        mask = torch.rand((b, lk), generator=g, device=cuda) < 0.7
        mask[:, 0] = True
        mask[0] = False                              # every key masked
    leaves = [t.detach().requires_grad_() for t in (q, kk, v)]
    before = k.flash_attention.launches
    out = k.flash_attention(*leaves, mask)
    assert k.flash_attention.launches == before + 1
    assert out.grad_fn is not None
    out.backward(go)
    cpu = [t.detach().cpu().requires_grad_() for t in (q, kk, v)]
    k.flash_attention_plain(*cpu, None if mask is None else mask.cpu()
                            ).backward(go.cpu())
    torch.cuda.synchronize()
    for a, r in zip(leaves, cpu):
        assert a.grad.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a.grad.cpu(), r.grad, rtol=1e-5,
                                       atol=1e-5)
        else:
            tol = 2.0 ** -6 * float(r.grad.float().abs().max())
            assert float((a.grad.cpu().float() - r.grad.float()).abs().max()
                         ) <= tol


def _grad_errors(gpu, cpu):
    """Per dense parameter (the tables left out): max |card - CPU| of .grad
    and max |CPU grad|."""
    cpu_params = dict(cpu.named_parameters())
    out = {}
    for n, p in gpu.named_parameters():
        if "table_dim" in n:
            continue
        ref = cpu_params[n].grad
        out[n] = (float((p.grad.cpu() - ref).abs().max()),
                  float(ref.abs().max()))
    return out


@pytest.mark.parametrize("name,conf", [
    ("din", "demo_din.yaml"), ("tabtransformer", "demo_ranking.yaml"),
    ("esim", "demo_ranking.yaml")])
def test_attention_ranking_gradients_card_match_cpu(cuda, name, conf):
    """One training forward and backward at dropout 0 on the card and on the
    CPU from the same weights: every dense parameter's gradient within
    1e-4 of its largest magnitude (f32 GEMMs, TF32 off, summed in another
    order); an attention key bias, whose exact gradient is 0 (softmax
    ignores a shift of a query's whole row), below 1e-5 of the model's
    largest gradient on both. The loss within rtol 1e-5; flash_attention
    launched (not for Din, which has no attention kernel)."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    c = Configuration(f"{tp.ROOT}/conf/{conf}")
    gpu, _ = build_network(name, {"conf": c, "dropout": 0.0, "device": cuda,
                                  "seed": 3})
    cpu, _ = build_network(name, {"conf": c, "dropout": 0.0, "device": "cpu"})
    cpu.load_state_dict({k_: v.cpu() for k_, v in gpu.state_dict().items()})
    batch = tp.to_torch(synthetic_batch(gpu.schema, 256, seed=4))
    before = k.flash_attention.launches
    g_loss, _ = gpu.train()({k_: v.to(cuda) for k_, v in batch.items()})
    g_loss.backward()
    c_loss, _ = cpu.train()(batch)
    c_loss.backward()
    torch.cuda.synchronize()
    assert (k.flash_attention.launches > before) == (name != "din")
    np.testing.assert_allclose(float(g_loss.detach()), float(c_loss.detach()),
                               rtol=1e-5)
    errs = _grad_errors(gpu, cpu)
    top = max(m for _, m in errs.values())
    for n, (err, mag) in errs.items():
        if n.endswith("mha.k.bias"):
            assert mag <= 1e-5 * top and \
                float(gpu.get_parameter(n).grad.abs().max()) <= 1e-5 * top, n
        else:
            assert err <= 1e-4 * mag, (n, err, mag)


def _trailing_pad_mask(cuda, b, l, seed):
    """[B, L] key masks of texts of 2..L tokens, padded at the end (the
    tokenizer's layout)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    lengths = torch.randint(2, l + 1, (b, 1), generator=g, device=cuda)
    return torch.arange(l, device=cuda)[None, :] < lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_text_recall_shape(cuda, dtype):
    """Kernel 6 at BERT-Base's [128, 12, 64, 64] over a batch's trailing-pad
    key masks, q, k, v the strided split_heads views: the forward against
    the plain version (f32 within 1e-5, bf16 within 2^-6 * max|v|) and the
    gradient against autograd through the plain version on the card (f32
    within 1e-5 + 1e-5 relative; bf16 within 2^-6 of each gradient's
    largest magnitude)."""
    from recommendflow_tpu_torch.ops.attention import split_heads
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    g = torch.Generator(device=cuda).manual_seed(128)
    q, kk, v = (split_heads(torch.randn((128, 64, 768), generator=g,
                                        device=cuda).to(dtype), 12)
                for _ in range(3))
    go = torch.randn((128, 12, 64, 64), generator=g, device=cuda).to(dtype)
    mask = _trailing_pad_mask(cuda, 128, 64, 1)
    leaves = [t.detach().requires_grad_() for t in (q, kk, v)]
    before = k.flash_attention.launches
    out = k.flash_attention(*leaves, mask)
    assert k.flash_attention.launches == before + 1
    ref_leaves = [t.detach().requires_grad_() for t in (q, kk, v)]
    ref = k.flash_attention_plain(*ref_leaves, mask)
    tol = 1e-5 if dtype == torch.float32 else \
        2.0 ** -6 * float(v.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol
    out.backward(go)
    ref.backward(go)
    torch.cuda.synchronize()
    for a, r in zip(leaves, ref_leaves):
        if dtype == torch.float32:
            torch.testing.assert_close(a.grad, r.grad, rtol=1e-5, atol=1e-5)
        else:
            tol = 2.0 ** -6 * float(r.grad.float().abs().max())
            assert float((a.grad.float() - r.grad.float()).abs().max()) <= tol


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.mark.parametrize("name,conf", [
    ("siamese_encoder", "demo_text_recall.yaml"), ("pdm", "demo_recall.yaml")])
def test_matching_gradients_card_match_cpu(cuda, name, conf):
    """SiameseEncoder (its text encoder's flash_attention with key masks,
    twice a forward) and Pdm (SelfAttention over the behaviour sequences):
    one training forward and backward at dropout 0 on the card and on the
    CPU from the same weights, held as test_attention_ranking_gradients_
    card_match_cpu holds them (Pdm's `attn_*.k.bias` is an attention key
    bias too)."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k
    c = Configuration(f"{tp.ROOT}/conf/{conf}")
    gpu, _ = build_network(name, {"conf": c, "device": cuda, "seed": 3})
    cpu, _ = build_network(name, {"conf": c, "device": "cpu"})
    cpu.load_state_dict({k_: v.cpu() for k_, v in gpu.state_dict().items()})
    _no_dropout(gpu), _no_dropout(cpu)
    batch = tp.to_torch(synthetic_batch(gpu.schema, 256, seed=4))
    before = k.flash_attention.launches
    g_loss, _ = gpu.train()({k_: v.to(cuda) for k_, v in batch.items()})
    g_loss.backward()
    c_loss, _ = cpu.train()(batch)
    c_loss.backward()
    torch.cuda.synchronize()
    assert k.flash_attention.launches > before
    np.testing.assert_allclose(float(g_loss.detach()), float(c_loss.detach()),
                               rtol=1e-5)
    errs = _grad_errors(gpu, cpu)
    top = max(m for _, m in errs.values())
    for n, (err, mag) in errs.items():
        if n.endswith("mha.k.bias") or (n.startswith("attn_")
                                        and n.endswith(".k.bias")):
            assert mag <= 1e-5 * top and \
                float(gpu.get_parameter(n).grad.abs().max()) <= 1e-5 * top, n
        else:
            assert err <= 1e-4 * mag, (n, err, mag)


def test_que2search_dense_step_matches_the_plain_update(cuda):
    """A Que2Search step on the dense table path (conf/demo_recall.yaml:
    both towers embed their own sparse features, so take_rows' backward
    builds one dense table gradient per tower and autograd adds them):
    scatter_add_rows launched once per tower and dim group; the table
    gradient within 1e-5 of its largest magnitude of the CPU's (duplicate
    sums in another order); rowwise_adagrad_update on it equals the plain
    update (p bitwise, acc rtol 1e-6, untouched rows bitwise); the loss
    within rtol 1e-5 of the CPU's."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    from recommendflow_tpu_torch.ops.cuda import table_update as kt
    from recommendflow_tpu_torch.train.trainer import Trainer, table_params
    conf = Configuration(f"{tp.ROOT}/conf/demo_recall.yaml")
    gpu, _ = build_network("que2search", {"conf": conf, "dropout": 0.0,
                                          "device": cuda, "seed": 5})
    cpu, _ = build_network("que2search", {"conf": conf, "dropout": 0.0,
                                          "device": "cpu"})
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batch = synthetic_batch(gpu.schema, 256, seed=9)
    t = Trainer(gpu, device=cuda)
    state = t.init_state(batch)
    assert t._split_dims == {}
    tables = table_params(gpu)
    passes = sum(len({s.dim for s in gpu.schema.tower_slots(tw)
                      if s.kind == "sparse"}) for tw in ("user", "ad"))
    before = [f.launches for f in (kr.scatter_add_rows,
                                   kt.rowwise_adagrad_update)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, _, phys, rows = t._forward_backward(t._put(batch))
        grads = {d: p.grad.clone() for d, p in tables.items()}
        p0 = {d: p.detach().clone() for d, p in tables.items()}
        acc0 = {d: state.table_acc[f"dim{d}"].clone() for d in tables}
        state.optimizer.step()
        t._apply_table_updates(state, phys, rows)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    launched = [f.launches - c for f, c in zip(
        (kr.scatter_add_rows, kt.rowwise_adagrad_update), before)]
    assert launched == [passes, len(tables)] and passes == 3
    tc = Trainer(cpu, device="cpu")
    tc.init_state(batch)
    c_loss, _, _, _ = tc._forward_backward(tc._put(batch))
    np.testing.assert_allclose(float(loss.detach()), float(c_loss.detach()),
                               rtol=1e-5)
    cpu_tables = table_params(cpu)
    for d, p in tables.items():
        ref = cpu_tables[d].grad
        assert float((grads[d].cpu() - ref).abs().max()) <= \
            1e-5 * float(ref.abs().max())
        acc = state.table_acc[f"dim{d}"]
        p_ref, acc_ref = p0[d].clone(), acc0[d].clone()
        kt.rowwise_adagrad_update_plain(p_ref, acc_ref, grads[d], lr=t.table_lr)
        torch.cuda.synchronize()
        assert _ulps(p.detach(), p_ref) == 0
        torch.testing.assert_close(acc, acc_ref, rtol=1e-6, atol=0)
        untouched = ~(grads[d] != 0).any(dim=1)
        assert untouched.any()
        assert torch.equal(p.detach()[untouched], p0[d][untouched])
        assert torch.equal(acc[untouched], acc0[d][untouched])


@pytest.mark.parametrize("cls,ops", [
    ("ranking.dcn.Dcn", {"recflow::gather_rows": 1}),
    ("ranking.tabtransformer.TabTransformer",
     {"recflow::gather_rows": 1, "recflow::flash_attention": 2})])
def test_export_on_the_card_equals_eager_and_launches_the_kernels(
        cuda, cls, ops, tmp_path):
    """A demo_ranking model exported on the card, saved and loaded there:
    the program holds the kernels' custom-op nodes and launches them, its
    outputs equal the eager model's bitwise (the same kernels and ATen ops),
    and the same artifact loaded on the CPU agrees within 1e-4 (the ranking
    logits' card-vs-CPU rule)."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.export import (ServingModel, custom_op_nodes,
                                                export_model)
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    from recommendflow_tpu_torch.ops.cuda import flash_attention as kf
    conf = Configuration(f"{tp.ROOT}/conf/demo_ranking.yaml")
    model, _ = build_network(f"recommendflow_tpu.models.{cls}",
                             {"conf": conf, "device": cuda, "seed": 0})
    batch = synthetic_batch(model.schema, 64, seed=9)
    labels = model.schema.label_names
    serve = {k: v for k, v in batch.items() if k not in labels}
    consts = {k: np.zeros_like(batch[k]) for k in labels}
    path = export_model(model, serve, str(tmp_path / "m"), constants=consts)
    sm = ServingModel.load(path, device="cuda")
    assert custom_op_nodes(sm.program) == ops
    before = (kr.gather_rows.launches, kf.flash_attention.launches)
    got = sm.predict(serve)
    torch.cuda.synchronize()
    launched = (kr.gather_rows.launches - before[0],
                kf.flash_attention.launches - before[1])
    assert launched == (ops["recflow::gather_rows"],
                        ops.get("recflow::flash_attention", 0))
    with torch.no_grad():
        want = model.eval()({k: v.to(cuda) for k, v in
                             tp.to_torch({**serve, **consts}).items()})
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k].cpu().numpy(), err_msg=k)
    cpu = ServingModel.load(path, device="cpu").predict(serve)
    np.testing.assert_allclose(cpu["logit"], got["logit"], rtol=0, atol=1e-4)


# ------------------------------------------------------ training options
@pytest.mark.parametrize("table_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("zipf", [0.0, 1.2])
def test_dcn_sparse_step_matches_the_plain_update(cuda, table_dtype, zipf):
    """A Dcn step under table_update="sparse" (demo_ranking): its touched-row
    update (gather_rows of the dense gradient's rows, sparse_adagrad_apply)
    against sparse_rowwise_adagrad_update_plain (the JAX form) on the same
    dense gradient: p bitwise, acc within rtol 1e-6, untouched rows bitwise;
    the step launches gather_rows, scatter_add_rows (the backward) and
    sparse_adagrad_apply once each for the table, never
    rowwise_adagrad_update."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    from recommendflow_tpu_torch.ops.cuda import sparse_apply as ks
    from recommendflow_tpu_torch.ops.cuda import table_update as kt
    from recommendflow_tpu_torch.ops.embedding import touched_stored_rows
    from recommendflow_tpu_torch.train.optimizers import (
        sparse_rowwise_adagrad_update_plain)
    from recommendflow_tpu_torch.train.trainer import Trainer, table_params
    conf = Configuration(f"{tp.ROOT}/conf/demo_ranking.yaml")
    conf.networks["table_dtype"] = table_dtype
    model, _ = build_network("dcn", {"conf": conf, "dropout": 0.0,
                                     "device": cuda, "seed": 5})
    batch = synthetic_batch(model.schema, 256, seed=9, zipf=zipf)
    t = Trainer(model, table_update="sparse", device=cuda)
    state = t.init_state(batch)
    (d,) = t._sparse_dims
    table = table_params(model)[d]
    p, acc = table.detach(), state.table_acc[f"dim{d}"]
    kernels = (kr.gather_rows, kr.scatter_add_rows, ks.sparse_adagrad_apply,
               kt.rowwise_adagrad_update)
    counts = [f.launches for f in kernels]
    db = t._put(batch)
    _, _, phys, rows = t._forward_backward(db)
    state.optimizer.step()
    g = table.grad.clone()
    sids = touched_stored_rows(model.schema, {f"dim{d}": p}, db)[f"dim{d}"]
    p0, acc0 = p.clone(), acc.clone()
    t._apply_table_updates(state, phys, rows, db)
    torch.cuda.synchronize()
    launched = [f.launches - c for f, c in zip(kernels, counts)]
    assert table.grad is None
    assert launched == [2, 1, 1, 0]        # forward gather, g's rows
    p_k, acc_k = p.clone(), acc.clone()
    p.copy_(p0), acc.copy_(acc0)
    sparse_rowwise_adagrad_update_plain(p, acc, g, sids, lr=t.table_lr)
    touched = torch.zeros(p.shape[0], dtype=torch.bool, device=cuda)
    touched[sids.long()] = True
    assert _ulps(p_k, p) == 0
    torch.testing.assert_close(acc_k, acc, rtol=1e-6, atol=0)
    bits = torch.int16 if p.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(p_k[~touched].view(bits), p0[~touched].view(bits))
    assert torch.equal(acc_k[~touched], acc0[~touched])


@pytest.mark.parametrize("case", ["sparse", "adam_clip", "logq"])
def test_training_option_steps_make_no_host_wait(cuda, case):
    """A step on a batch already on the card, under CUDA's sync debug mode
    ("error"): the touched-row update, make_optimizer's adam with its
    clip_norm (the global norm stays on the card) and the logQ stream's
    update never make the host wait."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer, make_optimizer
    conf = Configuration(f"{tp.ROOT}/conf/demo_recall.yaml")
    kw = {}
    if case == "sparse":
        kw = {"table_update": "sparse"}
    elif case == "adam_clip":
        kw = {"optimizer": make_optimizer(1e-3, "adam", clip_norm=1.0)}
    else:
        conf.networks["logq_feature"] = "item_id"
    model, _ = build_network("dssm", {"conf": conf, "device": cuda,
                                      "seed": 0})
    batches = [synthetic_batch(model.schema, 128, seed=s) for s in (1, 2)]
    t = Trainer(model, device=cuda, **kw)
    state = t.init_state(batches[0])
    state, _ = t.train_step(state, batches[0])     # warm: caches, lazy state
    db = t._put(batches[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = t._step(state, db)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(m["loss"])) and state.step == 2


@pytest.mark.parametrize("case", ["sparse", "dense", "adam", "lamb",
                                  "partitioned_adamw"])
def test_training_options_launch_their_kernels(cuda, case):
    """Dssm (demo_recall) steps launch the table kernels of their path:
    gather_rows and scatter_add_rows always (the embed pass and its
    backward), sparse_adagrad_apply on the touched-row path,
    rowwise_adagrad_update on the whole-table path and under
    make_partitioned_optimizer, neither under make_optimizer (elementwise
    over the dense table gradient); the losses finite."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    from recommendflow_tpu_torch.ops.cuda import sparse_apply as ks
    from recommendflow_tpu_torch.ops.cuda import table_update as kt
    from recommendflow_tpu_torch.train.trainer import (
        Trainer, make_optimizer, make_partitioned_optimizer)
    conf = Configuration(f"{tp.ROOT}/conf/demo_recall.yaml")
    model, _ = build_network("dssm", {"conf": conf, "device": cuda,
                                      "seed": 0})
    kw = {"sparse": {"table_update": "sparse"},
          "dense": {"table_update": "dense"},
          "adam": {"optimizer": make_optimizer(1e-3, "adam")},
          "lamb": {"optimizer": make_optimizer(1e-3, "lamb",
                                               weight_decay=1e-4)},
          "partitioned_adamw": {"optimizer": make_partitioned_optimizer(
              1e-3, dense_optimizer="adamw", weight_decay=1e-4)}}[case]
    batches = [synthetic_batch(model.schema, 128, seed=s) for s in (1, 2)]
    t = Trainer(model, device=cuda, **kw)
    state = t.init_state(batches[0])
    kernels = (kr.gather_rows, kr.scatter_add_rows, ks.sparse_adagrad_apply,
               kt.rowwise_adagrad_update)
    counts = [f.launches for f in kernels]
    for b in batches:
        state, m = t.train_step(state, b)
        assert np.isfinite(float(m["loss"]))
    n_tables = len(model.schema.groups)
    got = [f.launches - c for f, c in zip(kernels, counts)]
    want = {"sparse": [4 * n_tables, 2 * n_tables, 2 * n_tables, 0],
            "dense": [2 * n_tables, 2 * n_tables, 0, 2 * n_tables],
            "adam": [2 * n_tables, 2 * n_tables, 0, 0],
            "lamb": [2 * n_tables, 2 * n_tables, 0, 0],
            "partitioned_adamw": [2 * n_tables, 2 * n_tables, 0,
                                  2 * n_tables]}[case]
    assert got == want, (case, got)


@pytest.mark.parametrize("mode,strategy", [("split", "sparse_set"),
                                           ("split", "dense"),
                                           ("dense", "dense")])
def test_preempted_and_resumed_run_is_bitwise_on_the_card(cuda, tmp_path,
                                                          mode, strategy):
    import signal
    from recommendflow_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          state_to_host)
    from recommendflow_tpu_torch.train.trainer import \
        install_preemption_handler
    nets = {"tower_units": [64, 32]}
    ds = tp.demo_batches(4, seed=80)

    def trainer():
        return tp.demo_trainer(nets, device=cuda, table_update=mode,
                               split_strategy=strategy)
    torch.use_deterministic_algorithms(True, warn_only=True)
    t1 = trainer()
    saved = install_preemption_handler(t1)
    try:
        a = trainer().fit(ds, epochs=2, verbose=False)["state"]
        # step by step: a stack of steps (scan_steps=8 on a card) draws
        # the epoch's 4 batches, and the signal, before its first step
        r = t1.fit(tp.KillAt(ds, 3), epochs=2, preempt_dir=str(tmp_path),
                   scan_steps=1, verbose=False)
        assert r["preempted"] and 1 <= r["state"].step <= 4
        t2 = trainer()
        s2 = restore_checkpoint(str(tmp_path), t2.init_state(ds.batches[0]))
        b = t2.fit(ds, epochs=2, state=s2, verbose=False)["state"]
    finally:
        torch.use_deterministic_algorithms(False)
        for s, h in saved.items():
            signal.signal(s, h)
    assert a.step == b.step == 8
    ha, hb = state_to_host(a), state_to_host(b)
    for k, v in ha["model"].items():
        assert torch.equal(v, hb["model"][k]), k
    for k, v in ha["table_acc"].items():
        assert torch.equal(v, hb["table_acc"][k]), k
    for i, st in ha["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, hb["optimizer"]["state"][i][k]), (i, k)


# -------------------------------------------------------------- dispatch
# Trainer.train_steps on the card replays a CUDA graph of the step
# (train/graphs.py); under torch's deterministic algorithms (the duplicate
# sums add in one order) a replayed step computes what the eager step
# computes, bit for bit, dropout masks included (the generator is reseeded
# on the host before each replay, which reads its seed and offset).
_DISPATCH_NETS = {"tower_units": [64, 32]}


def _dispatch_options():
    from recommendflow_tpu_torch.train.trainer import (
        make_optimizer, make_partitioned_optimizer)
    n = _DISPATCH_NETS
    return {
        "split-dense": (n, dict(table_update="split", split_strategy="dense")),
        "split-sparse_set": (n, dict(table_update="split",
                                     split_strategy="sparse_set")),
        "split-sparse": (n, dict(table_update="split",
                                 split_strategy="sparse")),
        "table_update-dense": (n, dict(table_update="dense")),
        "table_update-sparse": (n, dict(table_update="sparse")),
        "lamb": (n, dict(optimizer=make_optimizer(1e-3, "lamb",
                                                  clip_norm=1.0))),
        "partitioned": (n, dict(optimizer=make_partitioned_optimizer(
            1e-3, dense_optimizer="adamw", weight_decay=1e-4,
            clip_norm=1.0))),
        "schedule": (n, dict(lr_schedule={"type": "cosine",
                                          "warmup_steps": 2,
                                          "decay_steps": 6})),
        "logq": (dict(n, logq_feature="item_id", logq_buckets=1024), {}),
        "bf16_mlp": (dict(n, compute_dtype="bfloat16"), {})}


def _host_state(state):
    from recommendflow_tpu_torch.train.checkpoint import state_to_host
    return state_to_host(state)


def _bitwise(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), (path, float((a.double() - b.double())
                                               .abs().max()))
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _bitwise(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("case", list(_dispatch_options()))
def test_graphed_steps_equal_eager_steps(cuda, deterministic, case):
    """Dssm on demo_recall (dropout 0.3), 5 steps: train_step five times
    against train_steps over the same batches (the first eager, the
    second captured and replayed, three more replays): the whole state
    bitwise, the metrics the eager steps' mean bitwise."""
    nets, kw = _dispatch_options()[case]
    batches = tp.demo_batches(6, seed=90, batch=128).batches
    ta = tp.demo_trainer(nets, device=cuda, **kw)
    sa = ta.init_state(batches[0])
    ms = []
    for b in batches[1:]:
        sa, m = ta.train_step(sa, b)
        ms.append(m)
    tb = tp.demo_trainer(nets, device=cuda, **kw)
    sb = tb.init_state(batches[0])
    sb, mb = tb.train_steps(sb, batches[1:])
    torch.cuda.synchronize()
    assert sa.step == sb.step == 5
    (st,) = tb.graph_stats()["train"]
    assert st["replays"] == 4 and st["pool_mb"] > 0
    _bitwise(_host_state(sa), _host_state(sb))
    for k, v in mb.items():
        assert torch.equal(v, torch.stack([m[k] for m in ms]).mean(0)), k


_ZOO = {
    "dcn": ("recommendflow_tpu.models.ranking.dcn.Dcn", "demo_ranking.yaml"),
    "deepfm": ("recommendflow_tpu.models.ranking.deepfm.DeepFm",
               "demo_ranking.yaml"),
    "xdeepfm": ("recommendflow_tpu.models.ranking.deepfm.XDeepFm",
                "demo_ranking.yaml"),
    "cold": ("recommendflow_tpu.models.preranking.cold.Cold",
             "demo_ranking.yaml"),
    "mmoe": ("recommendflow_tpu.models.ranking.mmoe.Mmoe",
             "demo_ranking.yaml"),
    "essm": ("recommendflow_tpu.models.ranking.essm.Essm",
             "demo_ranking.yaml"),
    "escm2": ("recommendflow_tpu.models.reranking.escm2.Escm2",
              "demo_ranking.yaml"),
    "din": ("recommendflow_tpu.models.ranking.din.Din", "demo_din.yaml"),
    "tabtransformer": ("recommendflow_tpu.models.ranking.tabtransformer."
                       "TabTransformer", "demo_ranking.yaml"),
    "esim": ("recommendflow_tpu.models.ranking.esim.Esim",
             "demo_ranking.yaml"),
    "mobius": ("recommendflow_tpu.models.matching.mobius.Mobius",
               "demo_recall.yaml"),
    "pdm": ("recommendflow_tpu.models.matching.pdm.Pdm", "demo_recall.yaml"),
    "que2search": ("recommendflow_tpu.models.matching.que2search.Que2Search",
                   "demo_recall.yaml"),
    "dssm_encoder": ("recommendflow_tpu.models.matching.dssm_encoder."
                     "DssmEncoder", "demo_text_recall.yaml"),
    "siamese_encoder": ("recommendflow_tpu.models.matching.siamese_encoder."
                        "SiameseEncoder", "demo_text_recall.yaml")}


@pytest.mark.parametrize("name", list(_ZOO))
def test_every_model_trains_and_evaluates_through_graphs(cuda, deterministic,
                                                         name):
    """Every model family the port trains, at its demo config's widths with
    its dropout, in the trainer's default update mode: 4 eager steps against
    train_steps over the same batches (bitwise), then the eval forward
    through its graph (Trainer.predict) against the eager forward
    (bitwise)."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer, to_device
    path, conf = _ZOO[name]
    c = Configuration(f"{tp.ROOT}/conf/{conf}")

    def trainer():
        m, _ = build_network(path, {"conf": c, "device": cuda, "seed": 3})
        return Trainer(m, device=cuda, seed=5)
    batches = [synthetic_batch(trainer().model.schema, 128, seed=20 + i)
               for i in range(5)]
    ta, tb = trainer(), trainer()
    sa, sb = ta.init_state(batches[0]), tb.init_state(batches[0])
    for b in batches[1:]:
        sa, _ = ta.train_step(sa, b)
    sb, _ = tb.train_steps(sb, batches[1:])
    torch.cuda.synchronize()
    assert tb.graph_stats()["train"][0]["replays"] == 3
    _bitwise(_host_state(sa), _host_state(sb))
    got = tb.predict(sb, batches[:3])
    tb.model.eval()
    with torch.no_grad():
        want = [tb.model(to_device(b, cuda)) for b in batches[:3]]
    assert tb.graph_stats()["eval"][0]["replays"] == 2
    for k, v in got.items():
        np.testing.assert_array_equal(
            v, torch.cat([w[k] for w in want]).cpu().numpy(), err_msg=k)


def test_graphed_steps_launch_counts_and_no_host_wait(cuda):
    """A replay launches what an eager step launches (the counts added
    through the replays); replays make the host wait for nothing (CUDA's
    sync debug mode "error")."""
    from recommendflow_tpu_torch.ops.cuda import launches
    batches = tp.demo_batches(6, seed=91, batch=128).batches
    ta = tp.demo_trainer(_DISPATCH_NETS, device=cuda)
    sa = ta.init_state(batches[0])
    sa, _ = ta.train_step(sa, batches[0])
    before = launches.snapshot()
    sa, _ = ta.train_step(sa, batches[1])
    per_step = launches.difference(launches.snapshot(), before)
    assert launches.total(per_step) > 0
    tb = tp.demo_trainer(_DISPATCH_NETS, device=cuda)
    sb = tb.init_state(batches[0])
    sb, _ = tb.train_steps(sb, batches[:2])           # eager, then captured
    on_card = [{k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
               for b in batches[2:]]
    torch.cuda.synchronize()
    before = launches.snapshot()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sb, _, n = tb._train_steps_stacked(
            sb, {k: torch.stack([b[k] for b in on_card]) for k in on_card[0]})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert n == 4 and sb.step == 6
    got = launches.difference(launches.snapshot(), before)
    for k, v in per_step.items():
        want = {kk: 4 * n for kk, n in v.items()} if isinstance(v, dict) \
            else 4 * v
        assert got[k] == want, (k, got[k], want)


def test_the_trace_reader_lists_kernel_1_of_graphed_steps(cuda, tmp_path):
    """utils/trace.py on a real card trace: three graphed steps (replays of
    a captured step) under utils/profiling.py:trace; the trace lists kernel
    1's symbol as often as its launch counter says, and the card's busy
    time lies inside the trace's span."""
    from recommendflow_tpu_torch.ops.cuda import embedding_bag
    from recommendflow_tpu_torch.utils.profiling import trace
    from recommendflow_tpu_torch.utils.trace import parse_trace
    batches = tp.demo_batches(5, seed=94, batch=128).batches
    t = tp.demo_trainer(_DISPATCH_NETS, device=cuda)
    s = t.init_state(batches[0])
    s, _ = t.train_steps(s, batches[:2])              # eager, then captured
    torch.cuda.synchronize()
    before = embedding_bag.gather_rows.launches
    with trace(str(tmp_path / "prof")):
        s, _ = t.train_steps(s, batches[2:])          # three replays
    launched = embedding_bag.gather_rows.launches - before
    rep = parse_trace(str(tmp_path / "prof"))
    listed = sum(op.count for op in rep.ops if "gather_rows_kernel" in op.key)
    assert launched > 0 and listed == launched, (listed, launched)
    assert 0 < rep.device_total_ms <= rep.span_ms
    assert t.graph_stats()["train"][0]["replays"] >= 3


_CAPTURE_FAILS = r"""
import sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + "/tests")
import torch
import _torch_parity as tp
from recommendflow_tpu_torch.train.trainer import make_optimizer
kw = {"optimizer": make_optimizer(1e-3, "lamb")} \
    if sys.argv[2] == "lamb" else {}
t = tp.demo_trainer({"tower_units": [64, 32]}, device="cuda", **kw)
batches = tp.demo_batches(3, seed=92, batch=64).batches
real = t._device_step

def with_a_host_read(state, batch):
    out = real(state, batch)
    out["loss"].item()                 # the host waits: not capturable
    return out

t._device_step = with_a_host_read
state = t.init_state(batches[0])
try:
    t.train_steps(state, batches)
    print("no error")
except RuntimeError as e:
    print("raised:", e)
print("step", state.step)
print("count", getattr(state.optimizer, "count", state.step))
"""


def test_a_capture_that_must_fail_raises(cuda):
    """A step that reads a value back to the host cannot be captured: the
    second step (the capture) raises, naming the operation, and nothing
    falls back to eager (the state stays at the one eager step), and a
    user optimizer's update count is taken back to the state's step. Under
    the default Adam and under lamb, each in a process of its own: a failed
    capture may leave the context unusable."""
    root = os.path.abspath(tp.ROOT)
    for optimizer in ("adam", "lamb"):
        r = subprocess.run([sys.executable, "-c", _CAPTURE_FAILS, root,
                            optimizer],
                           capture_output=True, text=True, timeout=300)
        said = r.stdout + r.stderr
        assert r.returncode == 0, said
        assert "raised:" in r.stdout and "no error" not in r.stdout, said
        assert "capturing a CUDA graph failed at aten._local_scalar_dense" \
            in r.stdout, said
        assert "step 1\ncount 1\n" in r.stdout, said


_FIRST_LAUNCH_CAPTURED = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
from recommendflow_tpu_torch.ops.cuda import _build
from recommendflow_tpu_torch.ops.cuda import flash_attention as k
_build.load("flash_attention")        # built and loaded, never launched
g = torch.Generator(device="cuda").manual_seed(0)
q, kk, v = (torch.randn((2, 3, 40, 32), generator=g, device="cuda")
            for _ in range(3))
mask = torch.rand((2, 40), generator=g, device="cuda") > 0.3
graph = torch.cuda.CUDAGraph()
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.graph(graph, stream=side):
    out = k.flash_attention(q, kk, v, mask)
graph.replay()
torch.cuda.synchronize()
err = float((out - k.flash_attention_plain(q, kk, v, mask)).abs().max())
print("err", err)
"""


def test_a_kernels_first_launch_can_be_captured(cuda):
    """flash_attention's first launch in a process sets its dynamic shared
    memory limit (cudaFuncSetAttribute, once): legal inside a capture in
    PyTorch's default (global) mode; the replay agrees with the plain
    version within 1e-5. In a process of its own, where nothing launched
    the kernel before."""
    root = os.path.abspath(tp.ROOT)
    r = subprocess.run([sys.executable, "-c", _FIRST_LAUNCH_CAPTURED, root],
                       capture_output=True, text=True, timeout=600)
    said = r.stdout + r.stderr
    assert r.returncode == 0, said
    err = float(r.stdout.split("err")[-1])
    assert err <= 1e-5, said


@pytest.mark.parametrize("first", ["eager", "graphed"])
def test_checkpoints_resume_bitwise_across_eager_and_graphed(
        cuda, deterministic, tmp_path, first):
    """4 steps one way against 2 steps one way, a checkpoint, a fresh
    trainer restored from it and 2 steps the other way: bitwise. A
    checkpoint in the port's earlier form (the plain Adam: LR a float, the
    step on the host) loads into the capturable Adam and trains on; a card
    checkpoint loads on the CPU."""
    from recommendflow_tpu_torch.train.checkpoint import (HOST_LR,
                                                          restore_checkpoint,
                                                          save_checkpoint)
    batches = tp.demo_batches(5, seed=93, batch=128).batches

    def run(t, s, bs, graphed):
        if graphed:
            return t.train_steps(s, bs)[0]
        for b in bs:
            s, _ = t.train_step(s, b)
        return s
    t = tp.demo_trainer(_DISPATCH_NETS, device=cuda)
    whole = run(t, t.init_state(batches[0]), batches[1:], False)
    t1 = tp.demo_trainer(_DISPATCH_NETS, device=cuda)
    s1 = run(t1, t1.init_state(batches[0]), batches[1:3], first == "graphed")
    path = save_checkpoint(str(tmp_path / "2.pt"), s1)
    t2 = tp.demo_trainer(_DISPATCH_NETS, device=cuda)
    s2 = restore_checkpoint(path, t2.init_state(batches[0]))
    s2 = run(t2, s2, batches[3:], first == "eager")
    torch.cuda.synchronize()
    _bitwise(_host_state(whole), _host_state(s2))
    # the earlier form: the plain Adam's groups and host steps
    saved = torch.load(path, weights_only=True)
    for g in saved["optimizer"]["param_groups"]:
        g["lr"] = g.pop(HOST_LR)
        g["capturable"] = False
    old = str(tmp_path / "old.pt")
    torch.save(saved, old)
    t3 = tp.demo_trainer(_DISPATCH_NETS, device=cuda)
    s3 = restore_checkpoint(old, t3.init_state(batches[0]))
    assert all(st["step"].device.type == "cuda"
               for st in s3.optimizer.state.values())
    s3 = run(t3, s3, batches[3:], True)
    torch.cuda.synchronize()
    _bitwise(_host_state(whole), _host_state(s3))
    t4 = tp.demo_trainer(_DISPATCH_NETS)                # on the CPU
    s4 = restore_checkpoint(path, t4.init_state(batches[0]))
    assert s4.optimizer.param_groups[0]["lr"] == 1e-3
    s4, m = t4.train_step(s4, batches[3])
    assert np.isfinite(float(m["loss"]))


def test_serving_model_replays_its_graph(cuda, tmp_path):
    """A demo Dcn export loaded on the card: ServingModel.predict replays
    the program's graph; bitwise against the program's fx module and the
    eager model on three batches, with gather_rows' launches counted
    through the replays (one a batch)."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.export import ServingModel, export_model
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    conf = Configuration(f"{tp.ROOT}/conf/demo_ranking.yaml")
    model, _ = build_network("dcn", {"conf": conf, "device": cuda,
                                     "seed": 0})
    labels = model.schema.label_names
    batches = [synthetic_batch(model.schema, 64, seed=30 + i)
               for i in range(3)]
    serve = [{k: v for k, v in b.items() if k not in labels} for b in batches]
    consts = {k: np.zeros_like(batches[0][k]) for k in labels}
    sm = ServingModel.load(export_model(model, serve[0], str(tmp_path / "m"),
                                        constants=consts), device="cuda")
    assert sm.graph is not None
    before = kr.gather_rows.launches
    got = [sm.predict(b) for b in serve]
    torch.cuda.synchronize()
    assert kr.gather_rows.launches - before == 3
    assert sm.graph.stats()[0]["replays"] == 4     # one when it was built
    model.eval()
    for b, g in zip(serve, got):
        with torch.no_grad():
            fx = sm._run({k: torch.from_numpy(v).to(cuda)
                          for k, v in b.items()})
            eager = model({k: v.to(cuda) for k, v in
                           tp.to_torch({**b, **consts}).items()})
        for k, v in g.items():
            np.testing.assert_array_equal(v, fx[k].cpu().numpy(), err_msg=k)
            np.testing.assert_array_equal(v, eager[k].cpu().numpy(),
                                          err_msg=k)


def test_a_dropped_trainer_frees_its_graphs(cuda):
    """A trainer's graph pools go with it: dropping the trainer (and its
    state) gives the allocator back at least the pools' memory."""
    import gc
    batches = tp.demo_batches(3, seed=94, batch=128).batches
    t = tp.demo_trainer(_DISPATCH_NETS, device=cuda)
    s = t.init_state(batches[0])
    s, _ = t.train_steps(s, batches)
    torch.cuda.synchronize()
    pool = sum(g["pool_mb"] for g in t.graph_stats()["train"]) * 1e6
    assert pool > 0
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    del t, s
    gc.collect()
    torch.cuda.empty_cache()
    assert held - torch.cuda.memory_reserved() >= pool


# ------------------------------------------------ SimBERT and the host tier
def test_full_mask_sdpa_on_the_card_matches_cpu(cuda):
    """A full [B, 1, Lq, Lk] mask (the UniLM mask) runs the vanilla maths on
    the card, launches no kernel 6, and agrees with the CPU within 1e-5."""
    from recommendflow_tpu_torch.ops import attention as tatt
    from recommendflow_tpu_torch.ops.cuda import flash_attention as kfa
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 3, 20, 16, generator=g) for _ in range(3))
    mask = torch.rand(4, 1, 20, 20, generator=g) > 0.4
    mask[..., 0] = True
    before = kfa.flash_attention.launches
    got = tatt.scaled_dot_product_attention(q.to(cuda), k.to(cuda),
                                            v.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == before and got.device.type == "cuda"
    ref = tatt.scaled_dot_product_attention(q, k, v, mask)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)


def test_simbert_loss_and_gradients_card_match_cpu(cuda):
    """A small SimBERT batch at dropout 0 on the card and on the CPU: the
    loss, both parts and every gradient (each leaf within 1e-4 of its
    largest; the key biases, exact gradient 0, below 1e-5 of the largest
    gradient); the seq2seq pass launches no kernel 6."""
    from recommendflow_tpu_torch.encoder import Tokenizer, build_demo_vocab
    from recommendflow_tpu_torch.encoder.generators import simbert_batches
    from recommendflow_tpu_torch.encoder.simbert import simbert_loss
    from recommendflow_tpu_torch.ops.cuda import flash_attention as kfa
    from recommendflow_tpu_torch.ops.transformer import TextEncoder
    words = ["red", "blue", "green", "cat", "dog", "bird", "fast", "slow"]
    vocab = build_demo_vocab(words)
    pairs = [(f"{a} {b}", f"{b} {a} {c}") for a, b, c in
             zip(words, words[1:] + words[:1], words[2:] + words[:2])]
    batch = next(simbert_batches(pairs, Tokenizer(vocab), 16, 12, seed=0))
    cpu = TextEncoder(len(vocab), num_layers=2, model_dim=64, num_heads=4,
                      ffn_hidden=128, max_len=24, dropout=0.0,
                      pos_type="learned", device="cpu", seed=3)
    card = TextEncoder(len(vocab), num_layers=2, model_dim=64, num_heads=4,
                       ffn_hidden=128, max_len=24, dropout=0.0,
                       pos_type="learned", device=cuda, seed=3)
    card.load_state_dict(cpu.state_dict())
    before = kfa.flash_attention.launches
    got, gaux = simbert_loss(card, {k: torch.from_numpy(v).to(cuda)
                                    for k, v in batch.items()})
    got.backward()
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == before
    ref, raux = simbert_loss(cpu, tp.to_torch(batch))
    ref.backward()
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    for name in ("lm_loss", "sim_loss"):
        assert abs(float(gaux[name]) - float(raux[name])) <= \
            1e-5 * abs(float(raux[name]))
    grads = {n: p.grad for n, p in cpu.named_parameters()}
    largest = max(float(g.abs().max()) for g in grads.values())
    for n, p in card.named_parameters():
        err = float((p.grad.cpu() - grads[n]).abs().max())
        if n.endswith("mha.k.bias"):
            assert max(float(p.grad.abs().max()),
                       float(grads[n].abs().max())) <= 1e-5 * largest, n
        else:
            assert err <= 1e-4 * float(grads[n].abs().max()), (n, err)


HOST_FORMS = [("HostFlat", "float32"), ("HostSQbf16", "bfloat16"),
              ("HostSQ8", "uint8")]


@pytest.mark.parametrize("spec,form", HOST_FORMS)
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_host_tier_card_matches_cpu(cuda, monkeypatch, spec, form, metric):
    """Each streamed form on the card against its CPU run: kernel 5's form
    launched once per block and query block; the same top-k (scores within
    1e-4, ids up to ties). Every scan is queued behind a 20 ms sleep on the
    card, so a copy that did not wait for the scan of its buffer's last
    block would overwrite it and break the agreement."""
    from recommendflow_tpu_torch.ops.cuda import grouped_topk
    from recommendflow_tpu_torch.retrieval import host_tier, index_factory
    real = host_tier.grouped_score_max

    def slow(*a, **k):
        torch.cuda._sleep(20_000_000)
        return real(*a, **k)

    monkeypatch.setattr(host_tier, "grouped_score_max", slow)
    rng = np.random.RandomState(7)
    vecs = rng.randn(40000, 96).astype(np.float32)
    qs = rng.randn(70, 96).astype(np.float32)
    kw = dict(block_items=8192, query_block=32)
    gpu = index_factory(96, spec, metric, device=cuda, **kw).train(vecs)
    cpu = index_factory(96, spec, metric, device="cpu", **kw).train(vecs)
    assert gpu._codes.is_pinned() and not cpu._codes.is_pinned()
    assert torch.equal(gpu._codes, cpu._codes)
    before = grouped_topk.grouped_score_max.launches_by_dtype[form]
    got = gpu.search(qs, 20, return_items=False)
    assert grouped_topk.grouped_score_max.launches_by_dtype[form] == \
        before + 5 * 3
    tp.agree(cpu.search(qs, 20, return_items=False), got, 1e-4)


@pytest.mark.parametrize("qtype", ["sq8", "bf16", "f32"])
def test_host_ivf_card_matches_cpu(cuda, tmp_path, qtype):
    """HostIvf with the CPU's trained layout carried over in its `.npz`: the
    union scorer launches kernel 5 once per query block, and the card's
    top-k equals the CPU's; a HostIvf built on the card holds the same
    codes and a probe recall above 0.9."""
    from recommendflow_tpu_torch.ops.cuda import grouped_topk
    from recommendflow_tpu_torch.retrieval import HostIvfSearcher
    rng = np.random.RandomState(8)
    centers = rng.randn(64, 32).astype(np.float32)
    vecs = centers[rng.randint(0, 64, 30000)] + \
        0.1 * rng.randn(30000, 32).astype(np.float32)
    qs = vecs[:48] + 0.02 * rng.randn(48, 32).astype(np.float32)
    kw = dict(qtype=qtype, nlist=64, nprobe=32, train_sample=8000,
              query_block=16)
    cpu = HostIvfSearcher(32, "ip", device="cpu", **kw).train(vecs)
    cpu.save(str(tmp_path / "ivf.npz"))
    gpu = HostIvfSearcher.load(str(tmp_path / "ivf.npz"), device=cuda)
    before = grouped_topk.grouped_score_max.launches
    got = gpu.search(qs, 10, return_items=False)
    assert grouped_topk.grouped_score_max.launches == before + 3
    tp.agree(cpu.search(qs, 10, return_items=False), got, 1e-4)
    built = HostIvfSearcher(32, "ip", device=cuda, **kw).train(vecs)
    np.testing.assert_array_equal(built.reconstruct(np.arange(100)),
                                  cpu.reconstruct(np.arange(100)))
    _, idx = built.search(qs, 10, return_items=False)
    golden = np.argsort(-(qs @ vecs.T), axis=1)[:, :10]
    assert np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(idx, golden)]) > 0.9


def test_host_tier_streams_within_its_memory_bound(cuda):
    """A streamed f32 search holds two block buffers, one block's group
    maxima and the tournament's gathered rows on the card, not the corpus:
    its peak stays below that bound and far below the 1 GB corpus."""
    from recommendflow_tpu_torch.retrieval import StreamingSqSearcher
    n, d, bn, nq, k = 1 << 22, 64, 1 << 18, 256, 10
    vecs = np.random.RandomState(9).randn(n, d).astype(np.float32)
    s = StreamingSqSearcher(d, "ip", qtype="f32", block_items=bn,
                            query_block=nq, device=cuda).train(vecs)
    qs = vecs[:nq] + 0.01
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, idx = s.search(qs, k, return_items=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    bound = 2 * bn * d * 4 + nq * (bn // 16) * 4 + nq * k * 16 * d * 4 \
        + (32 << 20)
    assert peak < bound < n * d * 4 // 4, (peak, bound)
    assert (idx[:, 0] == np.arange(nq)).all()


def test_host_tier_stream_waits_for_work_queued_before_it(cuda):
    """The stream's block buffers may take the memory of a tensor freed
    while queued work still reads it: the side stream's first copies must
    wait for that work (a sum queued behind a 0.2 s spin reads zeros, not
    the first block). Without the wait, a HostIvf build streamed its blocks
    over the k-means sample still being read, and its recall swung between
    runs."""
    from recommendflow_tpu_torch.retrieval import StreamingSqSearcher
    bn, d = 1 << 16, 64
    vecs = np.random.RandomState(10).rand(3 * bn, d).astype(np.float32) + 1
    s = StreamingSqSearcher(d, "ip", qtype="f32", block_items=bn,
                            device=cuda).train(vecs)
    for _ in range(3):
        x = torch.zeros((bn, d), device=cuda)
        torch.cuda._sleep(400_000_000)
        y = x.sum()
        del x
        for _, _, codes, _ in s._stream():
            pass
        assert float(y) == 0.0


# ------------------------------------------------------------ parallel (PR)
_WORLD_OF_ONE = textwrap.dedent('''
    import json, math, socket, sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    from recommendflow_tpu_torch.parallel import (init_distributed,
                                                  make_mesh,
                                                  sharded_gather_group)
    torch.backends.cuda.matmul.allow_tf32 = False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(0, 1, f"tcp://127.0.0.1:{port}", device="cuda")
    import torch.distributed as dist
    mesh = make_mesh()
    items = make_mesh(("items",), current=False)
    dev = mesh.device
    out = {"backend": dist.get_backend()}
    torch.use_deterministic_algorithms(True, warn_only=True)

    # 1. the sharded gather at the bench dim-64 bf16 layout, and its
    # gradient, against the single table's
    from recommendflow_tpu_torch.ops.embedding import gather_group
    class G: dim = 64
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((65536, 256), generator=gen, device=dev
                        ).to(torch.bfloat16)
    ids = torch.randint(0, 65536 * 4, (4096, 21), generator=gen, device=dev)
    w = torch.randn((4096, 21, 64), generator=gen, device=dev)
    a = table.clone().requires_grad_()
    b = table.clone().requires_grad_()
    ra = sharded_gather_group(mesh, "dp", a, G, ids)
    rb = gather_group(b, G, ids)
    (ra * w).sum().backward()
    (rb * w).sum().backward()
    out["gather"] = {
        "rows_bitwise": bool(torch.equal(ra, rb)),
        "grad_bitwise": bool(torch.equal(a.grad.view(torch.int16),
                                         b.grad.view(torch.int16)))}

    # 2. the sharded searchers against the resident ones
    from recommendflow_tpu_torch.retrieval import index_factory
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((300_000, 128), np.float32)
    queries = rng.standard_normal((256, 128), np.float32)
    out["search"] = {}
    for spec in ("Flat", "SQbf16", "SQ8"):
        r = index_factory(128, spec, "ip", device=dev).train(corpus)
        m = index_factory(128, spec, "ip", mesh=items).train(corpus)
        rs, ri = r.search(queries, 100, return_items=False)
        ms, mi = m.search(queries, 100, return_items=False)
        out["search"][spec] = {
            "ids_equal": float((ri == mi).mean()),
            "score_rel": float((np.abs(rs - ms) /
                                np.maximum(np.abs(rs), 1.0)).max())}

    # 3. three mesh steps (replicated, then row-sharded) against the
    # single card's
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer
    conf = Configuration(sys.argv[2])
    batches = [synthetic_batch(compile_schema(conf.features), 256,
                               seed=70 + i) for i in range(3)]

    def run(mesh_, shard, mode):
        model, _ = build_network(conf.networks["class"], {
            "conf": conf, "device": dev, "seed": 0})
        t = Trainer(model, table_update=mode, device=dev, mesh=mesh_,
                    shard_tables=shard)
        st = t.init_state(batches[0])
        losses = []
        for bt in batches:
            st, mt = t.train_step(st, bt)
            losses.append(float(mt["loss"]))
        state = {k: v.detach().float().cpu()
                 for k, v in model.state_dict().items()}
        state.update({"acc/" + k: v.cpu() for k, v in st.table_acc.items()})
        return losses, state

    out["steps"] = {}
    for name, mode, shard in (("replicated", "auto", False),
                              ("sharded", "sparse", True)):
        sl, ss = run(None, False, mode)
        ml, ms_ = run(mesh, shard, mode)
        worst = 0.0
        for k in ss:
            den = float(ss[k].abs().max()) or 1.0
            worst = max(worst, float((ms_[k] - ss[k]).abs().max()) / den)
        out["steps"][name] = {
            "loss_rel": max(abs(x - y) / abs(y) for x, y in zip(ml, sl)),
            "state_rel": worst}

    # 4. the mesh step as CUDA graph replays: fit in one stack of three
    # (the first step eager, the second captured, then replays) against
    # three eager steps, under deterministic algorithms
    def fitted(scan):
        model, _ = build_network(conf.networks["class"], {
            "conf": conf, "device": dev, "seed": 0})
        t = Trainer(model, device=dev, mesh=mesh)
        st = t.fit(batches, scan_steps=scan, verbose=False)["state"]
        replays = sum(g["replays"] for g in t.graph_stats().get("train", []))
        return {k: v.detach().cpu() for k, v in model.state_dict().items()
                }, replays
    eager, _ = fitted(1)
    graphed, replays = fitted(3)
    out["graphed"] = {"replays": replays, "bitwise": all(
        torch.equal(eager[k], graphed[k]) for k in eager)}
    dist.destroy_process_group()
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def world_of_one():
    """One process of a world of one over NCCL (a process of its own: the
    group must not outlive these tests): the sharded gather, the sharded
    searchers, three mesh steps, each beside its single-card counterpart,
    and the mesh step graphed beside eager. Its JSON result."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    root = os.path.abspath(tp.ROOT)
    r = subprocess.run([sys.executable, "-c", _WORLD_OF_ONE, root,
                        os.path.join(root, "conf", "demo_recall.yaml")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    import json
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_nccl_world_of_one_sharded_gather_is_the_single_gather(world_of_one):
    """At world 1 the masked gather keeps every row and the all-reduce is
    an identity: rows and the bf16 table gradient bitwise the single
    table's (deterministic algorithms: the duplicate sums in one order)."""
    assert world_of_one["backend"] == "nccl"
    assert world_of_one["gather"] == {"rows_bitwise": True,
                                      "grad_bitwise": True}


def test_nccl_world_of_one_sharded_search_is_the_resident_search(
        world_of_one):
    """300,000 x 128, 256 queries, k 100: the sharded Flat, SQbf16 and SQ8
    top-100s against the resident ones: scores within 1e-5 relative, ids
    equal but for at most 0.5% (the sharded tournament keeps k + 1 groups:
    where the resident's k miss an item, the sharded finds it)."""
    for spec, got in world_of_one["search"].items():
        assert got["ids_equal"] >= 0.995, (spec, got)
        assert got["score_rel"] <= 1e-5 or spec != "Flat", (spec, got)


def test_nccl_world_of_one_mesh_step_graph_replays_equal_eager(
        world_of_one):
    """The mesh step's NCCL collectives capture into the step's CUDA graph:
    a fit of three steps in one stack (replays > 0) bitwise the eager
    fit's weights and buffers."""
    got = world_of_one["graphed"]
    assert got["replays"] > 0 and got["bitwise"], got


def test_nccl_world_of_one_mesh_steps_match_the_single_card(world_of_one):
    """Three Dssm steps on demo_recall at batch 256 (dropout reseeded per
    step alike): replicated (split "auto") and row-sharded (legacy
    "sparse") mesh steps against the single card's, losses and every
    weight, buffer and accumulator within 1e-6 relative (BatchNorm's
    moments from all-reduced sums over n where the single card takes
    torch.mean)."""
    for name, got in world_of_one["steps"].items():
        assert got["loss_rel"] <= 1e-6 and got["state_rel"] <= 1e-6, \
            (name, got)


def _device_events(prof, tmp_path):
    """(name, start, end) of a profile's kernels, copies and fills (µs), by
    start."""
    import json
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((str(e["name"]), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X" and "dur" in e
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                  key=lambda ev: ev[1])


def _busy_us(events, t0, t1):
    """The union of the events' intervals inside [t0, t1)."""
    total, reach = 0.0, t0
    for _, s, e in events:
        s, e = max(s, reach), min(e, t1)
        if e > s:
            total += e - s
            reach = e
    return total


def test_a_graphed_step_marks_its_six_phases_once_per_replay(cuda, tmp_path):
    """Eight replays of a Dssm step (demo_recall, towers 1024-512-256,
    batch 1024) under a profiler of the device's activity alone: each
    replay holds the six rf_span_ markers once, in the step's order, and
    the five phases' busy time (each from its marker to the next) sums to
    the replay's busy time (its first marker to the end of its last) within
    1%: the end marker alone lies outside them. A kernel and a wait open
    the profile: a profiler can drop the first event of its session."""
    from recommendflow_tpu_torch.ops.cuda.span_marker import PHASES
    t = tp.demo_trainer({"tower_units": [1024, 512, 256]}, device="cuda",
                        split_strategy="dense")
    batches = tp.demo_batches(12, seed=5, batch=1024).batches
    st = t.init_state(batches[0])
    st, _ = t.train_steps(st, batches[:4])         # eager, captured, replays
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        st, _ = t.train_steps(st, batches[4:])
        torch.cuda.synchronize()
    events = _device_events(prof, tmp_path)
    marks = [(n.split("rf_span_")[1], s, e) for n, s, e in events
             if "rf_span_" in n]
    assert [m[0] for m in marks] == list(PHASES) * 8, [m[0] for m in marks]
    for r in range(8):
        step = marks[6 * r:6 * r + 6]
        phases = sum(_busy_us(events, a[1], b[1]) for a, b in zip(step, step[1:]))
        whole = _busy_us(events, step[0][1], step[-1][2])
        assert all(_busy_us(events, a[1], b[1]) > 0 for a, b in zip(step, step[1:]))
        assert abs(whole - phases) <= 0.01 * whole, (r, whole, phases)


def test_markers_launch_eagerly_only_while_recording(cuda, monkeypatch):
    """An eager step on the card launches its six markers, in the step's
    order, only under a profiler. Counted at the launch: a profiler does not
    list every eager launch of a ctypes library's kernels (its own CUDA
    runtime; tools/profile_slice.py), so the trace is not the count."""
    from recommendflow_tpu_torch.ops.cuda import span_marker
    real, launched = span_marker.launch_marker, []

    def counted(phase, device):
        launched.append(phase)
        real(phase, device)
    monkeypatch.setattr(span_marker, "launch_marker", counted)
    t = tp.demo_trainer({"tower_units": [64, 32]}, device="cuda",
                        split_strategy="dense")
    batches = tp.demo_batches(3, seed=6, batch=256).batches
    st = t.init_state(batches[0])
    t.train_step(st, batches[0])
    torch.cuda.synchronize()
    assert launched == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        t.train_step(st, batches[1])
        torch.cuda.synchronize()
    assert launched == list(span_marker.PHASES)


def test_no_garbage_is_collected_inside_a_capture(cuda):
    """StepGraph captures with the garbage collector off, and on again
    after: a dead cycle that holds another CUDA graph must not be destroyed
    inside a capture, which forbids that call. The eager first run collects
    as usual."""
    import gc
    from recommendflow_tpu_torch.train.graphs import StepGraph
    seen = []

    def step(t):
        seen.append(gc.isenabled())
        return {"y": t["x"] * 2}
    g = StepGraph(torch.device("cuda"), "gc")
    x = torch.arange(8.0, device="cuda")
    for _ in range(3):                  # eager, captured, replayed
        out = g(step, {"x": x})
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert torch.equal(out["y"], x * 2)


# combine_row_grads' tables at the benchmark's shapes, (ids a step, stored
# width, stored rows): Dcn/Criteo's 23 (batch 512; portbench/configs/
# dcn_criteo.json's fields grouped by dim) and Dssm's two at
# conf/bench_recall.yaml's widths (batch 1024)
DCN_TABLES = [(1024, 256, 1), (512, 11, 10), (1024, 12, 33), (512, 13, 24),
              (512, 14, 27), (512, 19, 105), (512, 25, 305), (512, 29, 583),
              (512, 30, 633), (512, 37, 1460), (512, 41, 2173),
              (512, 45, 3194), (1024, 52, 11335), (512, 63, 12517),
              (512, 66, 14992), (512, 105, 93145), (512, 117, 142572),
              (512, 139, 286181), (512, 231, 2202608), (512, 290, 5461306),
              (512, 309, 7046547), (512, 323, 8351593), (512, 339, 10131227)]
DSSM_TABLES = [(2048, 256, 256), (87040, 256, 1505024)]


def _combine_tables(cuda, specs, seed, dtype=torch.bfloat16):
    """Zipf(1.2) stored-row ids (the hot row a third into the table) and
    random row gradients, one (ids, g, rows) per spec."""
    rng = np.random.default_rng(seed)
    out = []
    for n, width, rows in specs:
        ids = ((rng.zipf(1.2, n) - 1 + rows // 3) % rows).astype(np.int32)
        g = rng.standard_normal((n, width), dtype=np.float32) * 0.01
        out.append((torch.from_numpy(ids).to(cuda),
                    torch.from_numpy(g).to(cuda).to(dtype), rows))
    return out


def _combine_against_plain(tables):
    """The kernel against the plain version on the card: uid, valid and
    n_valid equal, the f32 sums within reordering (the plain version adds
    by float atomics): rtol 1e-5, atol 1e-5, for sums of up to ~16,000
    terms of ~0.01 whose partial sums reach ~3 (2^-24 of that, times the
    square root of the terms, is ~2e-5 at worst; 3e-6 seen)."""
    from recommendflow_tpu_torch.ops.cuda import row_grad_combine as rgc
    got = rgc.combine_row_grads(tables)
    want = rgc.combine_row_grads_plain(tables)
    torch.cuda.synchronize()
    for (s, u, v, n), (rs, ru, rv, rn) in zip(got, want):
        assert torch.equal(n, rn) and torch.equal(u, ru) and torch.equal(v, rv)
        torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_combine_row_grads_kernel_against_plain(cuda, dtype):
    """Zipf(1.2) tables of widths 256 (vector loads), 339, 8 and 64, one of
    a single id: the 60,000-id table's hot row takes over 10,000 ids, a run
    across some 300 chunks of 32, summed without atomics. One grouped call."""
    from recommendflow_tpu_torch.ops.cuda import row_grad_combine as rgc
    tables = _combine_tables(cuda, [(60000, 256, 1505024), (40000, 339, 500000),
                                    (5000, 8, 90), (1, 64, 10)], 3, dtype)
    hot = int(torch.bincount(tables[0][0].long()).max())
    assert hot > 10000
    before = rgc.combine_row_grads.launches
    by = dict(rgc.combine_row_grads.launches_by_tables)
    got = _combine_against_plain(tables)
    assert rgc.combine_row_grads.launches == before + 1
    assert rgc.combine_row_grads.launches_by_tables[4] == by.get(4, 0) + 1
    # the views lie in one call's buffers, the sums past n_valid are zero
    for summed, uid, valid, n_valid in got:
        assert not summed[int(n_valid):].any()
        assert int(valid.sum()) == int(n_valid)


@pytest.mark.parametrize("layout", ["dcn", "dssm"])
def test_combine_row_grads_at_the_benchmark_layouts(cuda, layout):
    """Dcn's 23 tables and Dssm's two in one grouped call each, bitwise
    equal across two runs and to each table's call alone."""
    from recommendflow_tpu_torch.ops.cuda import row_grad_combine as rgc
    specs = DCN_TABLES if layout == "dcn" else DSSM_TABLES
    tables = _combine_tables(cuda, specs, 5)
    by = dict(rgc.combine_row_grads.launches_by_tables)
    first = _combine_against_plain(tables)
    again = rgc.combine_row_grads(tables)
    torch.cuda.synchronize()
    assert rgc.combine_row_grads.launches_by_tables[len(specs)] == \
        by.get(len(specs), 0) + 2
    for a, b, t in zip(first, again, tables):
        alone, = rgc.combine_row_grads([t])
        for x, y, z in zip(a, b, alone):
            assert torch.equal(x, y) and torch.equal(x, z)


def test_combine_row_grads_sixty_four_bit_keys(cuda):
    from recommendflow_tpu_torch.ops.cuda import row_grad_combine as rgc
    specs = [(3000, 32, (1 << 29) + 7)] + [(400, 8, 1000)] * 15
    assert rgc.plan_layout(*zip(*specs)).key64
    _combine_against_plain(_combine_tables(cuda, specs, 7, torch.float32))


def test_combine_row_grads_graph_replay_equals_eager(cuda):
    """The grouped call captured by StepGraph: each replay bitwise the eager
    call on the same inputs, and counted once a replay."""
    from recommendflow_tpu_torch.ops.cuda import row_grad_combine as rgc
    from recommendflow_tpu_torch.train.graphs import StepGraph
    specs = DSSM_TABLES

    def step(b):
        out = rgc.combine_row_grads(
            [(b[f"ids{t}"], b[f"g{t}"], rows)
             for t, (_, _, rows) in enumerate(specs)])
        return {f"{k}{t}": x for t, o in enumerate(out)
                for k, x in zip(("summed", "uid", "valid", "n_valid"), o)}
    graph = StepGraph(cuda, "combine")
    for seed in range(3):                  # eager, captured, replayed
        tables = _combine_tables(cuda, specs, 20 + seed)
        batch = {**{f"ids{t}": ids for t, (ids, _, _) in enumerate(tables)},
                 **{f"g{t}": g for t, (_, g, _) in enumerate(tables)}}
        before = rgc.combine_row_grads.launches
        got = {k: v.clone() for k, v in graph(step, batch).items()}
        assert rgc.combine_row_grads.launches == before + 1
        want = step(batch)
        torch.cuda.synchronize()
        assert all(torch.equal(got[k], want[k]) for k in want)
    (st,) = graph.stats()
    assert st["replays"] == 2 and st["launches"]["combine_row_grads"] == 1
    assert st["launches"]["combine_row_grads_by_tables"] == {2: 1}


def test_split_step_combines_once_a_step(cuda):
    """A graphed split step on demo_recall (dim8 and dim16 split tables)
    makes one grouped call a step over both."""
    from recommendflow_tpu_torch.ops.cuda import row_grad_combine as rgc
    t = tp.demo_trainer({"tower_units": [64, 32]}, device=cuda,
                        split_strategy="auto")
    batches = tp.demo_batches(8, seed=4).batches
    state = t.init_state(batches[0])
    before = rgc.combine_row_grads.launches
    by = dict(rgc.combine_row_grads.launches_by_tables)
    t.train_steps(state, batches)
    torch.cuda.synchronize()
    assert rgc.combine_row_grads.launches == before + 8
    assert rgc.combine_row_grads.launches_by_tables[2] == by.get(2, 0) + 8
    (st,) = t.graph_stats()["train"]
    assert st["launches"]["combine_row_grads_by_tables"] == {2: 1}
