"""The traffic generator: a mix repeats exactly for a seed and differs
across seeds; the batch generator is the program's synthetic_batch draw for
draw; the sample of answers kept for the check is drawn from the seed."""
import numpy as np
import pytest
import torch

from portbench.harness import traffic as gen
from portbench.harness.cell import Cell
from portbench.reference.layout import Layout
from portbench.tests.small import small_config

SEEDS = (7, 2**31 + 9)


@pytest.mark.parametrize("config", ["dssm_recall", "dcn_criteo"])
def test_pool_repeats_for_a_seed_and_differs_across_seeds(config):
    layout = Layout(small_config(config))
    a = gen.batch_pool(layout, 16, 3, SEEDS[0], 1.2)
    b = gen.batch_pool(layout, 16, 3, SEEDS[0], 1.2)
    c = gen.batch_pool(layout, 16, 3, SEEDS[1], 1.2)
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys() == z.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        assert any(not np.array_equal(x[k], z[k]) for k in x)


@pytest.mark.parametrize("config", ["dssm_recall", "dcn_criteo"])
@pytest.mark.parametrize("zipf", [0.0, 1.2])
def test_batch_is_the_programs_synthetic_batch(config, zipf):
    from recommendflow_tpu_torch.config.configuration import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    cfg = small_config(config)
    schema = compile_schema(Configuration(conf=cfg["port_conf"]).features)
    ours = gen.zipf_batch(Layout(cfg), 24, 123, zipf)
    theirs = synthetic_batch(schema, 24, seed=123, zipf=zipf)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


def kept(n, k, seed):
    r = gen.Reservoir(k, seed)
    for i in range(n):
        r.offer(i, ("answer", i))
    return r.kept


def test_the_kept_sample_is_drawn_from_the_seed_over_every_answer():
    a, b, c = kept(1000, 8, SEEDS[0]), kept(1000, 8, SEEDS[0]), kept(1000, 8, SEEDS[1])
    assert a == b and a != c
    assert len(a) == 8 and all(v == ("answer", i) for i, v in a.items())
    assert kept(5, 8, SEEDS[0]) == {i: ("answer", i) for i in range(5)}
    # uniform over the answers: every quarter of a long window is sampled
    seen = set()
    for seed in range(200):
        seen |= {i // 250 for i in kept(1000, 8, seed)}
    assert seen == {0, 1, 2, 3}


def test_catalogue_repeats():
    x = gen.catalogue(64, 8, 4, 0.35, 3, torch.device("cpu"))
    y = gen.catalogue(64, 8, 4, 0.35, 3, torch.device("cpu"))
    z = gen.catalogue(64, 8, 4, 0.35, 4, torch.device("cpu"))
    assert torch.equal(x, y) and not torch.equal(x, z)


@pytest.mark.parametrize("mix", ["train_zipf", "serve_top100", "score_2048"])
def test_every_mix_is_a_data_file_the_generator_reads(mix):
    cells = [w["name"] for w in Cell("dssm_recall-train_zipf").bench["workloads"]
             if w["traffic"] == mix]
    assert cells
    cell = Cell(cells[0])
    assert cell.traffic["path"] in ("fit", "recall_search", "export_score")
    assert float(cell.traffic["zipf"]) > 1.0
