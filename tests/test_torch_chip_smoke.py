"""chip_smoke.py's contract where there is no card: it exits non-zero and
prints no result, alone in a directory as well, and its CPU rehearsal drives
every phase at toy sizes through the plain versions (the serving slice, the
training run of the three table-update modes, the ranking runs of Dcn and
the other ranking models, the training options (the touched-row update, the
optimizer family, a schedule, logQ, the bf16 MLP), TabTransformer's attention-ranking run with its
gradient check, SiameseEncoder's text_recall run with its graft and
gradient checks, SimBERT's training on the UniLM mask with its causality
and gradient checks, the other matching models, the export and /predict
serving of Dcn, TabTransformer and Dssm, the quantized and approximate
searchers, the host-RAM tier's streamed and IVF searches, the recall ->
rank cascade, the text encoder's encode and HTTP serving, the text search, the
CLIs with cli/export and cli/serve --model, and the dispatch phase's stacks
of steps, a preemption inside a stack and the served exports)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import _torch_parity as tp

SCRIPT = os.path.join(tp.ROOT, "chip_smoke.py")
# every phase but the build and the timings, which need the card
REHEARSED = ("gather_rows", "grouped_score_max", "scatter_add_rows",
             "rowwise_adagrad_update", "sparse_adagrad_apply",
             "combine_row_grads", "flash_attention", "slice", "train", "ranking", "train_options",
             "long_runs", "dispatch", "ranking_zoo",
             "attention_ranking", "text_recall", "simbert", "matching_zoo",
             "export_serve", "sq_search", "ann", "host_tier", "parallel",
             "cascade", "encode", "serve", "text_search", "cli")


def _run(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def _has_result(stdout):
    return '"ok": true' in stdout or '"kernels"' in stdout


def _held(check, control=True):
    """A gradient check's readings: in the rehearsal the "card" is the CPU,
    so its f32 gradient is the CPU's; the f64 reference ran; the control
    fault (kernel 6 dropping a key) ran on a model with kernel 6 and broke
    the rule."""
    assert check["worst_rel_err"] <= check["tolerance"]
    assert check["k_bias_rel"] <= check["k_bias_tolerance"]
    assert check["worst_vs_f64"]["card"] == check["worst_vs_f64"]["cpu"] > 0
    assert check["loss_f64"] == pytest.approx(check["loss_cpu"], rel=1e-5)
    if control:
        assert check["control"]["calls"] > 0
        assert check["control"]["margin"] > 1
    else:
        assert "control" not in check


def test_no_card_no_result(tmp_path):
    r = _run([SCRIPT], tp.ROOT)
    assert r.returncode != 0 and not _has_result(r.stdout)
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    r = _run([str(lone)], str(tmp_path))
    assert r.returncode != 0 and not _has_result(r.stdout)


def test_cpu_rehearsal_drives_every_phase(tmp_path):
    r = _run([SCRIPT, "--cpu-rehearsal"], str(tmp_path))
    assert r.returncode == 3, r.stderr[-3000:]
    assert not _has_result(r.stdout)
    phases = {}
    for line in r.stdout.splitlines():
        if line.startswith('{"phase"'):
            rec = json.loads(line)
            phases[rec["phase"]] = rec
    assert sorted(phases) == sorted(REHEARSED)
    par = phases["parallel"]       # a world of one over gloo on the CPU
    assert par["backend"] == "gloo" and par["world"] == 1
    assert par["row_sharded"] == ["embedder.table_dim16"]
    assert sorted(par["steps_check"]) == ["replicated", "replicated_graphed",
                                          "sharded"]
    for name, check in par["steps_check"].items():
        assert check["state_max_rel_err"] <= par["tolerance"]
        if name != "replicated_graphed":
            assert check["loss_rel_err"] <= par["tolerance"]
    assert sorted(par["search"]["checks"]) == ["Flat", "SQ8", "SQbf16"]
    cas = phases["cascade"]         # the recall -> rank cascade, demo size
    assert cas["stage2"]["hit@50"] == cas["stage1"]["hit@50"]
    assert cas["topk_check"]["score_rel_err"] <= 4e-6
    assert sorted(cas["seconds"]) == sorted(cas["launches_by_stage"])
    assert phases["gather_rows"]["bitwise_equal"] is True
    assert max(phases["grouped_score_max"]["max_abs_err"].values()) <= 1e-4
    assert {"u8_ip", "u8_l2"} <= set(phases["grouped_score_max"]["max_abs_err"])
    assert phases["scatter_add_rows"]["bitwise_equal"] is True
    for name in ("rowwise_adagrad_update", "sparse_adagrad_apply"):
        assert phases[name]["p_ulps"] == 0 and phases[name]["untouched_bitwise"]
    assert phases["slice"]["top100_score_err"] <= 1e-5
    train = phases["train"]
    assert sorted(train["runs"]) == ["dense", "sparse_set", "table_dense", "warm"]
    # one entry per split strategy and table: "<strategy>/dim<d>"
    assert sorted({k.split("/")[0] for k in train["update_check"]}) == [
        "dense", "sparse_set"]
    assert all(c["p_ulps"] == 0 for c in train["update_check"].values())
    assert all(k.startswith("val_") for k in train["recall"])
    assert phases["cli"]["predict_vs_model"] <= 1e-5
    assert phases["cli"]["trained_predict_vs_model"] <= 1e-5
    rcli = phases["cli"]["ranking_cli"]
    assert 0 <= rcli["train"]["val_auc"] <= 1 and 0 <= rcli["evaluate"]["auc"] <= 1
    assert rcli["predict_vs_model"] <= 1e-5
    assert rcli["export_serve_predict_vs_predict_cli"] <= 1e-5
    xs = phases["export_serve"]
    assert sorted(xs["models"]) == ["Dcn", "Dssm", "TabTransformer"]
    nodes = {name: m["custom_op_nodes"] for name, m in xs["models"].items()}
    assert nodes == {"Dcn": {"recflow::gather_rows": 1},
                     "TabTransformer": {"recflow::gather_rows": 1,
                                        "recflow::flash_attention": 2},
                     "Dssm": {"recflow::gather_rows": 2}}
    for m in xs["models"].values():
        assert m["max_abs_vs_eager"] == 0.0 and m["artifact_mb"] > 0
        assert m["export_s"] > 0 and m["load_s"] > 0
    assert xs["models"]["Dssm"]["outputs"] == ["ad", "user"]   # no label echo
    assert xs["http"]["health"]["endpoints"] == ["/health", "/predict"]
    assert xs["http"]["bitwise"] is True and xs["http"]["bad_id_code"] == 400
    assert xs["cpu_vs_card_logit"] <= xs["cpu_tolerance"]
    rank = phases["ranking"]
    assert sorted(rank["runs"]) == ["auto", "auto_zipf1.2", "dense",
                                    "sparse_set", "warm"]
    assert rank["runs"]["auto"]["split"] == {"dim16": "dense"}   # a small table
    assert rank["runs"]["sparse_set"]["split"] == {"dim16": "sparse_set"}
    assert all(0 <= r["val_auc"] <= 1 for r in rank["runs"].values())
    assert rank["cpu_vs_card_logit"] <= rank["cpu_tolerance"]
    assert sorted(rank["update_check"]) == [
        f"{s}/zipf{z}/dim16" for s in ("dense", "sparse_set")
        for z in (0.0, 1.2)]
    assert all(c["p_ulps"] == 0 for c in rank["update_check"].values())
    opts = phases["train_options"]
    assert sorted(opts["ranking"]["runs"]) == ["dense", "sparse"]
    assert opts["ranking"]["host_waits_sparse_step"] == 0
    check = opts["ranking"]["update_check"]
    assert check["p_ulps"] == 0 and check["untouched_bitwise"]
    assert check["acc_rel_err"] <= 1e-6 and check["touched_rows"] > 0
    assert sorted(opts["optimizers"]) == ["adagrad", "adam", "adamw", "lamb",
                                          "partitioned_adamw", "sgd"]
    assert opts["planner"] == {}                       # timed on the card only
    lrs = opts["schedule"]["lrs"]
    assert lrs[0] == lrs[1] == 0.0 and max(lrs) == pytest.approx(1e-3)
    assert opts["logq"]["stream_steps"] == [1, 2, 3]
    assert opts["logq"]["buckets_seen"] == sorted(opts["logq"]["buckets_seen"])
    bf16 = opts["bf16"]
    assert 0 < max(bf16["row_l2_vs_f32"].values()) <= bf16["tolerance"]
    lr = phases["long_runs"]
    assert lr["resume"]["bitwise"] and lr["resume"]["steps"] == 12
    assert 1 <= lr["resume"]["preempted_at_step"] <= 4
    assert lr["profile"]["optimizer_steps"] == 3
    assert lr["finetune"]["blocked"].startswith("model promotion blocked")
    disp = phases["dispatch"]
    assert disp["dssm_fit"]["bitwise_scan8_vs_scan1"]
    assert disp["dssm_fit"]["preempted_at_step"] == 11
    assert disp["dssm_fit"]["resumed_bitwise"]
    assert sorted(disp["paths"]) == [
        "dcn/split/dense", "dcn/split/sparse_set",
        "dcn/split/sparse_set/nondeterministic", "dcn/table_update/dense",
        "dcn/table_update/sparse", "dssm/auto", "dssm/cosine_warmup",
        "dssm/lamb_clip1", "siamese_encoder", "tabtransformer"]
    assert all(p["bitwise"] for k, p in disp["paths"].items()
               if not k.endswith("nondeterministic"))
    assert disp["paths"]["dssm/cosine_warmup"]["lrs"][:2] == [0.0, 5e-4]
    assert sorted(disp["exports"]) == ["Dcn", "Dssm", "TabTransformer"]
    assert all(x["bitwise"] for x in disp["exports"].values())
    assert disp["exports"]["Dcn"]["predict_http_bitwise"]
    assert all(e["bitwise"] for e in disp["eval"].values())
    zoo = phases["ranking_zoo"]["models"]
    assert sorted(zoo) == ["Cold", "DeepFm", "Din", "Escm2-dr", "Escm2-ips",
                           "Esim", "Essm", "Mmoe", "TabTransformer", "XDeepFm"]
    assert zoo["Din"]["config"] == "demo_din.yaml"
    for name in ("Din", "TabTransformer", "Esim"):
        _held(zoo[name]["grad_check"], control=name != "Din")
    attn = phases["attention_ranking"]
    assert sorted(attn["runs"]) == ["auto", "warm"]
    assert all(0 <= r["val_auc"] <= 1 for r in attn["runs"].values())
    assert attn["cpu_vs_card_logit"] <= attn["cpu_tolerance"]
    _held(attn["grad_check"])
    assert attn["grad_check"]["tab.block0.mha.q.weight_grad_max"] > 0
    assert attn["attention_shape"][1:] == [4, 10, 4]   # demo: 10 fields of 16
    text = phases["text_recall"]
    assert text["graft_bitwise"] is True
    assert sorted(text["runs"]) == ["train", "warm"]
    assert all(0 <= v <= 1 for k, v in text["recall"].items()
               if k.startswith("val_hit@"))
    assert text["attention_shape"] == [16, 4, 64, 16]  # the toy BERT
    assert text["cpu_vs_card"] <= text["cpu_tolerance"]
    _held(text["grad_check_grafted"])
    _held(text["grad_check"])
    assert text["grad_check"]["encoder.tok_emb.weight_grad_max"] > 0
    assert 0 < text["valid_key_share"] < 1
    fa_text = text["flash_attention_check"]
    assert fa_text["inputs"] == 4                      # 2 layers x 2 towers
    assert fa_text["max_abs_err"] <= fa_text["tolerance"]
    assert fa_text["grad_rel_err"] <= fa_text["grad_tolerance"]
    mzoo = phases["matching_zoo"]["models"]
    assert sorted(mzoo) == ["Dssm-image", "Dssm-vit", "DssmEncoder", "Mobius",
                            "Pdm", "Que2Search", "Que2Search-recall"]
    assert mzoo["Que2Search-recall"]["config"] == "demo_recall.yaml"
    assert "relevance" in mzoo["Mobius"]["outputs"]
    assert mzoo["Pdm"]["split"] == {} and mzoo["Mobius"]["split"]
    for name in ("Pdm", "DssmEncoder", "Que2Search", "Dssm-vit"):
        assert sorted(mzoo[name]["grad_check"]) == ["built", "trained"]
        for check in mzoo[name]["grad_check"].values():
            _held(check)
    assert all(m["cpu_vs_card"] <= 1e-5 for m in mzoo.values())
    tcli = phases["cli"]["text_cli"]
    assert all(0 <= v <= 1 for k, v in tcli["train"].items()
               if k.startswith("val_hit@"))
    assert tcli["predict_vs_model"] <= 1e-5
    dcli = phases["cli"]["din_cli"]
    assert 0 <= dcli["train"]["val_auc"] <= 1 and 0 <= dcli["evaluate"]["auc"] <= 1
    assert dcli["predict_vs_model"] <= 1e-5
    assert "feature_gates" in zoo["Cold"]["outputs"]
    assert {"score0", "score1", "label1"} <= set(zoo["Mmoe"]["outputs"])
    fa = phases["flash_attention"]["cases"]
    assert {k.split("/")[0] for k in fa} == {"float32", "bfloat16"}
    assert any("lk200_d128" in k for k in fa)
    assert any("lk200_d256" in k for k in fa)
    assert {"float32/tabtransformer", "bfloat16/tabtransformer"} <= set(fa)
    backward = phases["flash_attention"]["backward"]
    assert sorted(backward) == ["encoder_masked", "tabtransformer"]
    assert all(max(b["rel_err"].values()) <= b["tolerance"]
               for b in backward.values())
    assert all(c["max_abs_err"] <= c["tolerance"] for c in fa.values())
    enc = phases["encode"]
    assert enc["batches"] == 8 and enc["cache_equal"]
    assert enc["unit_norm_err"] <= 1e-4 and enc["cpu_vs_card"] <= 1e-4
    assert 0 < enc["tokens"]["truncated_share"] < 0.5
    serve = phases["serve"]
    assert serve["health"]["device"] == "cpu"
    assert serve["served_vs_direct"] == 0.0
    assert serve["concurrent_encode_calls"] <= serve["concurrent_requests"]
    assert phases["cli"]["encode_cli_vs_service"] <= 1e-6
    sq = phases["sq_search"]
    assert sorted(sq["results"]) == sorted(sq["checks"]) == ["Flat", "SQ8",
                                                             "SQbf16"]
    for c in sq["checks"].values():
        assert c["score_rel_err"] <= sq["tolerance"]
    assert sq["results"]["SQbf16"]["recall@100_vs_flat"] > 0.95
    ann = phases["ann"]
    assert sorted(ann["checks"]) == ["IVF64,PQ16@full_probe",
                                     "IVF64@full_probe", "PQ16"]
    assert set(ann["results"]) == {"Flat", "IVF64", "PQ16", "IVF64,PQ16"}
    assert all(0 < r["recall@100_vs_flat"] <= 1 for k, r in ann["results"].items()
               if k != "Flat")
    sb = phases["simbert"]
    assert sb["batch"] == [16, 32] and sb["segment1_tokens"] > 0
    assert sb["causality"]["earlier_bitwise"]
    assert sb["causality"]["changed_moved"] > 0
    assert sb["loss_rel_err"] <= sb["loss_tolerance"]
    _held(sb["grad_check"], control=False)
    assert sb["loss_curve"][-1] < sb["loss_curve"][0]
    assert sb["launches"]["flash_attention"] == 0
    host = phases["host_tier"]
    assert sorted(host["results"]) == sorted(host["checks"]) == [
        "HostFlat", "HostSQ8", "HostSQbf16"]
    assert host["checks"]["HostFlat"]["score_rel_err"] <= host["tolerance"]
    for spec in ("HostSQ8", "HostSQbf16"):
        assert host["checks"][spec]["vs_function"]["score_rel_err"] <= \
            host["tolerance"]
        assert host["checks"][spec]["vs_resident"]["recall"] > 0.99
    assert host["checks"]["HostFlat"]["index_match"] > 0.99
    assert host["results"]["HostSQbf16"]["recall@100_vs_flat"] > 0.95
    assert host["stream"] == {}                        # timed on the card only
    ivf = host["host_ivf"]
    assert ivf["HostSQ8_vs_full_probe"]["recall"] > 0.99
    assert 0 < ivf["nprobe8"]["recall@100_vs_flat"] <= \
        ivf["nprobe32"]["recall@100_vs_flat"] <= 1
    assert phases["text_search"]["self_in_top10"] == 1.0
    assert phases["text_search"]["tournament"] is False
