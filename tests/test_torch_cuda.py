"""The CUDA kernels and the port's device paths on an NVIDIA card.

Marked `cuda`; each test skips without a card. On the card (JAX is not
needed there, so conftest.py is skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernel 1 must equal its plain version bitwise; kernel 2 agrees to atol 1e-4
(f32 sums in another order); the search and the model agree with their CPU
runs to 1e-5 and 2e-5.
"""
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


@pytest.mark.parametrize("dtype,width", [
    (torch.float32, 16), (torch.float32, 64), (torch.float32, 3),
    (torch.bfloat16, 64), (torch.bfloat16, 32), (torch.float16, 5),
    (torch.bfloat16, 256)])
def test_gather_rows_kernel_bitwise(cuda, dtype, width):
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as k1
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((5000, width), generator=g, device=cuda).to(dtype)
    ids = torch.randint(0, 5000, (3001,), generator=g, device=cuda,
                        dtype=torch.int32)
    before = k1.gather_rows.launches
    got = k1.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert k1.gather_rows.launches == before + 1
    assert torch.equal(got, k1.gather_rows_plain(table, ids))
    with pytest.raises(IndexError):
        k1.gather_rows(table, torch.tensor([0, 5000], dtype=torch.int32,
                                           device=cuda))
    with pytest.raises(ValueError):
        k1.gather_rows(table, ids.long())


@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("q,n_pad,d,group", [
    (37, 1024 + 64, 40, 16), (256, 4096, 128, 16), (5, 512, 7, 4),
    (130, 2048, 64, 64)])
def test_grouped_score_max_kernel(cuda, vec_dtype, l2, q, n_pad, d, group):
    from recommendflow_tpu_torch.ops.cuda import grouped_topk as k2
    g = torch.Generator(device=cuda).manual_seed(1)
    qs = torch.randn((q, d), generator=g, device=cuda)
    v = torch.randn((n_pad, d), generator=g, device=cuda).to(vec_dtype)
    sqn = (v.float() ** 2).sum(1) if l2 else None
    num_items = n_pad - 3 * group // 2
    got = k2.grouped_score_max(qs, v, sqn, group=group, num_items=num_items)
    ref = k2.grouped_score_max_plain(qs, v, sqn, group=group,
                                     num_items=num_items)
    torch.cuda.synchronize()
    assert got.shape == (q, n_pad // group)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        k2.grouped_score_max(qs, v, sqn, group=12, num_items=num_items)


def test_flat_searcher_card_matches_cpu(cuda):
    from recommendflow_tpu_torch.ops.cuda import grouped_topk as k2
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    rng = np.random.RandomState(0)
    vecs = rng.randn(262144 - 1000, 128).astype(np.float32)
    qs = rng.randn(50, 128).astype(np.float32)
    before = k2.grouped_score_max.launches
    _, s_gpu, i_gpu = FlatSearcher(128, "cos", device=cuda).train(vecs).search(qs, 100)
    assert k2.grouped_score_max.launches == before + 1
    _, s_cpu, i_cpu = FlatSearcher(128, "cos", device="cpu").train(vecs).search(qs, 100)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=0, atol=1e-5)
    assert (i_gpu == i_cpu).mean() > 0.99


def test_dssm_card_matches_cpu(cuda):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as k1
    from recommendflow_tpu_torch.train.trainer import predict
    conf = Configuration(tp.DEMO_CONF)
    conf.networks["table_dtype"] = "bfloat16"
    gpu = Dssm(conf, device=cuda, seed=3)
    cpu = Dssm(conf, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batches = [synthetic_batch(gpu.schema, 64, seed=i) for i in range(3)]
    before = k1.gather_rows.launches
    a = predict(gpu, batches, cuda)
    assert k1.gather_rows.launches == before + 2 * 3   # two dim groups
    b = predict(cpu, batches, "cpu")
    for k in ("user", "ad"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-5)
