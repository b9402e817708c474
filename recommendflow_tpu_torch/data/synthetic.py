"""Synthetic demo data: config-driven generation of RFB record files.

Generates a two-tower style interaction log with a planted structure
(users prefer items whose latent category matches theirs) so recall metrics
on the demo config move away from chance when training works.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.config.proto import FeatureDeal, FeatureTower
from recommendflow_tpu_torch.data.recordio import RecordWriter
from recommendflow_tpu_torch.data.writer import columns_for


from functools import lru_cache


@lru_cache(maxsize=64)
def _category_png(cat: int, n_cat: int) -> bytes:
    """Tiny solid-color PNG whose hue encodes the category (image-deal demo)."""
    import colorsys
    import io

    from PIL import Image
    r, g, b = colorsys.hsv_to_rgb(cat / max(n_cat, 1), 0.9, 0.9)
    img = Image.new("RGB", (16, 16), (int(r * 255), int(g * 255), int(b * 255)))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def generate_records(conf: Configuration,
                     out_dir: str,
                     num_rows: int = 10000,
                     num_files: int = 2,
                     num_users: int = 2000,
                     num_items: int = 500,
                     seed: int = 0) -> List[str]:
    rng = np.random.RandomState(seed)
    specs = columns_for(conf)
    feats = {f.name: f for f in conf.features.train_features}
    os.makedirs(out_dir, exist_ok=True)

    n_cat = 16
    user_cat = rng.randint(0, n_cat, size=num_users)
    item_cat = rng.randint(0, n_cat, size=num_items)
    item_ctr = rng.beta(2, 50, size=num_items).astype(np.float32)

    def make_row(i: int) -> Dict[str, list]:
        u = rng.randint(num_users)
        # planted preference: 70% of positives share category
        if rng.rand() < 0.5:
            cands = np.where(item_cat == user_cat[u])[0]
            it = int(rng.choice(cands)) if len(cands) else rng.randint(num_items)
            label = 1.0
        else:
            it = rng.randint(num_items)
            label = float(item_cat[it] == user_cat[u]) if rng.rand() < 0.3 else 0.0
        clicks = rng.choice(np.where(item_cat == user_cat[u])[0], size=min(5, num_items),
                            replace=True) if rng.rand() < 0.8 else rng.randint(
            num_items, size=3)
        row: Dict[str, list] = {}
        for name, f in feats.items():
            if name == "conversion":
                # post-click conversion: only clicked impressions can
                # convert (the ESSM/ESCM2 task structure)
                row[name] = [label * float(rng.rand() < 0.4)]
            elif f.tower == FeatureTower.Label or name == "label":
                row[name] = [label]
            elif name in ("user_cat_a", "user_cat_b"):
                # planted: the user's latent category, exposed directly
                # (demo_ranking's lookup features; _b adds 20% noise)
                c = int(user_cat[u]) if (name.endswith("_a") or
                                         rng.rand() > 0.2) \
                    else rng.randint(n_cat)
                row[name] = [c]
            elif name in ("item_cat_a", "item_cat_b"):
                c = int(item_cat[it]) if (name.endswith("_a") or
                                          rng.rand() > 0.2) \
                    else rng.randint(n_cat)
                row[name] = [c]
            elif name == "stat_ctr":
                row[name] = [float(item_ctr[it])]
            elif name == "stat_cvr":
                row[name] = [float(item_ctr[it] * 0.3)]
            elif f.deal == FeatureDeal.TokenId and f.tower in (
                    FeatureTower.User, FeatureTower.Ad):
                # planted text signal: tokens draw from the latent
                # category's 8-id block (user tower -> user's category, ad
                # tower -> item's) — matching pairs share vocabulary, so
                # token encoders (ESIM/siamese/Que2Search) can learn the
                # click structure
                cat = int(user_cat[u] if f.tower == FeatureTower.User
                          else item_cat[it])
                base = 1 + cat * 8
                row[name] = rng.randint(base, base + 8, size=8).tolist()
            elif name == "user_id":
                row[name] = [f"u{u}"]
            elif name == "item_id":
                row[name] = [f"i{it}"]
            elif name == "clk_item_ids":
                row[name] = [f"i{c}" for c in clicks]
            elif name == "clk_cat_ids":
                row[name] = [int(item_cat[c]) for c in clicks]
            elif name == "item_cat_id":
                row[name] = [int(item_cat[it])]
            elif name == "item_ctr":
                row[name] = [float(item_ctr[it])]
            elif name == "item_cvr":
                row[name] = [float(item_ctr[it] * 0.3)]
            elif f.deal == FeatureDeal.Hashing:
                # honor the declared dtype: an int-typed hashing feature's
                # column is stored as int64 — string tokens would crash the
                # writer (caught by tests/test_config_fuzz.py)
                k = max(1, min(f.max_len, 4))
                if f.type == "int":
                    row[name] = rng.randint(0, 100000, size=k).tolist()
                else:
                    row[name] = [f"{name}_{rng.randint(1000)}"
                                 for _ in range(k)]
            elif f.deal == FeatureDeal.Lookup:
                # draw from the actual vocab (matching its dtype) so lookup
                # features aren't all-OOV for string vocabs
                k = max(1, min(f.max_len, 4))
                if isinstance(f.vocabs, (list, tuple)) and f.vocabs:
                    row[name] = [f.vocabs[rng.randint(len(f.vocabs))]
                                 for _ in range(k)]
                else:
                    row[name] = rng.randint(
                        0, max(f.vocab_size, 1), size=k).tolist()
            elif f.deal == FeatureDeal.Discrete:
                row[name] = [float(rng.rand())]
            elif f.deal == FeatureDeal.Embedding:
                # fixed-width pre-computed vector column
                row[name] = rng.randn(max(f.max_len, 1)).astype(
                    np.float32).tolist()
            elif f.deal == FeatureDeal.TokenId:
                row[name] = rng.randint(1, 100, size=8).tolist()
            elif f.deal == FeatureDeal.BertEncode:
                words = ("search rank click buy phone game music video news "
                         "shop app store play read watch food travel sport "
                         "photo chat mail map bank car home work learn code "
                         "data cloud smart fast best top new hot free").split()
                k = rng.randint(2, 6)
                row[name] = [" ".join(rng.choice(words, size=k))]
            elif f.deal == FeatureDeal.Image:
                # planted visual signal: solid color keyed by item category
                row[name] = [_category_png(int(item_cat[it]), n_cat)]
            else:
                row[name] = [0.0] if f.type == "float" else [0]
        return row

    paths = []
    per_file = num_rows // num_files
    for fi in range(num_files):
        path = os.path.join(out_dir, f"part-{fi:05d}.rfb")
        with RecordWriter(path, specs) as w:
            for i in range(per_file):
                w.write_row(make_row(fi * per_file + i))
        paths.append(path)
    return paths


def bayes_ceiling(num_users: int = 2000, num_items: int = 500,
                  seed: int = 0, n_samples: int = 500_000) -> float:
    """Bayes-optimal AUC of the planted click model in generate_records.

    The generator's click rule (make_row above — keep in sync):
      branch A (p=0.5): item uniform over M(u) = items matching the user's
        latent category, label=1 (item uniform over all if M(u) empty);
      branch B (p=0.5): item uniform over all N items,
        label = [cat match] * [rand < 0.3].
    The posterior P(label=1 | u, it) is therefore exactly
        match:    (0.5/m + 0.15/N) / (0.5/m + 0.5/N),  m = |M(u)|
        nomatch:  0
    (or 0.5 for every item when m = 0 — branch A always labels 1).
    This score depends only on OBSERVABLE features (user/item category are
    exposed via user_cat_a/item_cat_a in demo_ranking and clk_cat_ids /
    item_cat_id in demo_recall; m is a function of user category), so the
    ceiling is information-theoretically reachable by the zoo models —
    what keeps a trained model below it is estimation error, not hidden
    state. Returns the oracle's AUC over a large simulated draw of rows
    from the same (user_cat, item_cat) world (latents drawn exactly as
    generate_records draws them for this seed).
    """
    from recommendflow_tpu_torch.train.metrics import roc_auc
    rng = np.random.RandomState(seed)
    n_cat = 16
    user_cat = rng.randint(0, n_cat, size=num_users)
    item_cat = rng.randint(0, n_cat, size=num_items)
    m_per_cat = np.bincount(item_cat, minlength=n_cat).astype(np.float64)

    sim = np.random.RandomState(seed + 10_007)
    u = sim.randint(num_users, size=n_samples)
    uc = user_cat[u]
    m = m_per_cat[uc]
    branch_a = sim.rand(n_samples) < 0.5
    # branch A item: uniform over the m matching items — for the oracle we
    # only need the item's category, which is uc itself when m > 0
    it_b = sim.randint(num_items, size=n_samples)
    match_b = item_cat[it_b] == uc
    match = np.where(branch_a, m > 0, match_b)
    label = np.where(
        branch_a, 1.0,
        (match_b & (sim.rand(n_samples) < 0.3)).astype(np.float64))
    with np.errstate(divide="ignore"):
        s_match = (0.5 / m + 0.15 / num_items) / (0.5 / m + 0.5 / num_items)
    score = np.where(match, s_match, np.where(m == 0, 0.5, 0.0))
    return float(roc_auc(label, score))


def synthetic_batch(schema, batch_size: int, seed: int = 0,
                    zipf: float = 0.0):
    """One random device-shaped batch straight from a compiled schema
    (ids/dense/labels only — no record files). Used by the export CLI's
    sample batch, the entry points, and the benchmarks.

    zipf > 1 draws sparse ids Zipf(zipf)-distributed instead of uniform —
    real CTR ids are Zipfian, which changes the duplicate ratio the
    embedding-table scatter sees (benchmarks/bench_ranking.py --zipf)."""
    rng = np.random.RandomState(seed)
    batch = {}
    for name in schema.order:
        s = schema.slots[name]
        if s.kind == "sparse":
            shape = (batch_size,) + s.batch_shape
            if zipf and zipf > 1.0:
                ids = (rng.zipf(zipf, size=shape) - 1) % s.num_rows
                batch[name] = ids.astype(np.int32)
            else:
                batch[name] = rng.randint(
                    0, s.num_rows, size=shape).astype(np.int32)
        elif s.kind == "dense":
            batch[name] = rng.rand(batch_size, *s.batch_shape).astype(np.float32)
        else:
            batch[name] = rng.randint(
                0, 100, size=(batch_size,) + s.batch_shape).astype(np.int32)
    for name in schema.label_names:
        batch[name] = (rng.rand(batch_size) > 0.5).astype(np.float32)
    return batch
