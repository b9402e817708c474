"""SimBERT in the port (`encoder/simbert.py`, `TextEncoder(seq2seq=True)`)
against the JAX package on the CPU.

* The UniLM hidden states of the port's TextEncoder against flax's, the
  weights carried by `interop.load_jax_variables`: within 1e-5 (f32 sums in
  another order through two layers and five LayerNorms).
* unilm_lm_loss and simbert_similarity_loss on the same numpy inputs: 1e-6
  relative.
* simbert_loss and every gradient against `jax.value_and_grad` of the JAX
  simbert_loss: each leaf within 1e-5 of its largest magnitude; the
  attention key biases, whose exact gradient is 0 (softmax ignores a shift
  of a query's whole row), below 1e-5 of the model's largest gradient on
  both sides.
* 30 + 1 steps of the port's make_optimizer adam (3e-3) against optax.adam
  on tests/test_simbert.py's tiny model and batch: every parameter within
  1e-4, the losses within 1e-4 relative, and falling as JAX's do. The key
  biases are left out of the parameter check: their exact gradient is 0,
  so Adam turns each side's summation noise into steps of ±lr, and no
  output depends on them (the final models' UniLM hidden states agree
  within 1e-4).
* The properties the JAX tests pin: causality (a late segment-1 token
  changes no earlier position) and the CLS blind to the target sentence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

from recommendflow_tpu.encoder import Tokenizer as JaxTokenizer
from recommendflow_tpu.encoder.generators import \
    simbert_batches as jax_simbert_batches
from recommendflow_tpu.encoder.simbert import simbert_loss as jax_simbert_loss
from recommendflow_tpu.encoder.simbert import \
    simbert_similarity_loss as jax_sim_loss
from recommendflow_tpu.encoder.simbert import unilm_lm_loss as jax_lm_loss
from recommendflow_tpu.ops.transformer import TextEncoder as JaxTextEncoder
from recommendflow_tpu_torch.encoder import Tokenizer, build_demo_vocab
from recommendflow_tpu_torch.encoder.generators import simbert_batches
from recommendflow_tpu_torch.encoder.simbert import (simbert_loss,
                                                     simbert_similarity_loss,
                                                     unilm_lm_loss)
from recommendflow_tpu_torch.interop import (flatten, jax_from_variables,
                                             load_jax_variables)
from recommendflow_tpu_torch.ops.transformer import TextEncoder
from recommendflow_tpu_torch.train.optimizers import make_optimizer

WORDS = ["red", "blue", "green", "cat", "dog", "bird", "fast", "slow"]
PAIRS = [("red cat", "blue cat"), ("fast dog", "slow dog"),
         ("green bird", "red bird"), ("red fast", "blue fast")]
HIDDEN_ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
ADAM_TOL = 1e-4


def _tiny(vocab_size, max_len=16):
    kw = dict(vocab_size=vocab_size, num_layers=2, model_dim=32, num_heads=2,
              ffn_hidden=64, max_len=max_len, dropout=0.0, pos_type="learned")
    return JaxTextEncoder(**kw), kw


def _pair(vocab_size, ids, seg, seed=0):
    """(jax module, its variables as numpy, the port module holding them)."""
    jm, kw = _tiny(vocab_size)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(seg)))
    tm = TextEncoder(**kw, device="cpu")
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _batch(batch_size=8, max_len=8):
    vocab = build_demo_vocab(WORDS)
    b = next(simbert_batches(PAIRS, Tokenizer(vocab), batch_size=batch_size,
                             max_len=max_len, shuffle=False))
    return len(vocab), b


def _mixed_inputs(seed=3, batch=6, length=14, vocab=64):
    """Random token rows with a segment boundary per row and trailing pads."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, vocab, size=(batch, length)).astype(np.int32)
    seg = np.zeros_like(ids)
    for r in range(batch):
        cut = rng.randint(2, length - 3)
        end = rng.randint(cut + 2, length + 1)
        seg[r, cut:end] = 1
        ids[r, end:] = 0
    return ids, seg


def _hidden(tm, ids, seg):
    with torch.no_grad():
        return tm(torch.from_numpy(ids), torch.from_numpy(seg), seq2seq=True,
                  return_sequence=True).numpy()


def test_unilm_hidden_states_match_flax():
    ids, seg = _mixed_inputs()
    jm, v, tm = _pair(64, ids, seg)
    ref = np.asarray(jm.apply(v, jnp.asarray(ids), jnp.asarray(seg),
                              seq2seq=True, return_sequence=True))
    got = _hidden(tm, ids, seg)
    np.testing.assert_allclose(got, ref, rtol=0, atol=HIDDEN_ATOL)
    # the mask changes the result: the bidirectional pass differs
    bidir = np.asarray(jm.apply(v, jnp.asarray(ids), jnp.asarray(seg),
                                return_sequence=True))
    assert np.abs(bidir - ref).max() > 1e-3


def test_losses_match_jax():
    rng = np.random.RandomState(1)
    hidden = rng.randn(3, 9, 16).astype(np.float32)
    emb = rng.randn(40, 16).astype(np.float32)
    ids, seg = _mixed_inputs(seed=4, batch=3, length=9, vocab=40)
    ref = float(jax_lm_loss(jnp.asarray(hidden), jnp.asarray(emb),
                            jnp.asarray(ids), jnp.asarray(seg)))
    got = float(unilm_lm_loss(torch.from_numpy(hidden), torch.from_numpy(emb),
                              torch.from_numpy(ids), torch.from_numpy(seg)))
    assert got == pytest.approx(ref, rel=LOSS_RTOL)
    for scale in (30.0, 5.0):
        cls = rng.randn(8, 16).astype(np.float32)
        ref = float(jax_sim_loss(jnp.asarray(cls), scale=scale))
        got = float(simbert_similarity_loss(torch.from_numpy(cls), scale=scale))
        assert got == pytest.approx(ref, rel=LOSS_RTOL)
    with pytest.raises(ValueError, match="paired rows"):
        simbert_similarity_loss(torch.zeros(3, 4))


def test_lm_loss_counts_only_real_segment1_targets():
    """Segment-0 and pad targets contribute nothing, and a batch with no
    segment-1 target gives 0 (the JAX max(sum(w), 1) denominator)."""
    rng = np.random.RandomState(5)
    hidden = torch.from_numpy(rng.randn(2, 8, 16).astype(np.float32))
    emb = torch.from_numpy(rng.randn(32, 16).astype(np.float32))
    tok = torch.from_numpy(rng.randint(4, 32, size=(2, 8)))
    seg = torch.tensor([[0, 0, 0, 1, 1, 1, 0, 0]] * 2)
    a = unilm_lm_loss(hidden, emb, tok, seg)
    b = unilm_lm_loss(hidden, emb, torch.where(seg == 0, 5, tok), seg)
    assert float(a) == pytest.approx(float(b), rel=1e-6)
    assert float(unilm_lm_loss(hidden, emb, tok, torch.zeros_like(seg))) == 0.0


def test_simbert_loss_and_gradients_match_jax():
    vocab_size, batch = _batch()
    jm, v, tm = _pair(vocab_size, batch["tok"], batch["seg"], seed=2)
    jb = tp.to_jax(batch)

    def lf(variables):
        return jax_simbert_loss(jm, variables, jb, training=False)

    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(lf, has_aux=True)(
        jax.tree.map(jnp.asarray, v))
    loss, aux = simbert_loss(tm, tp.to_torch(batch))
    loss.backward()
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for name in ("lm_loss", "sim_loss"):
        assert float(aux[name].detach()) == pytest.approx(float(ref_aux[name]),
                                                 rel=1e-5)
    got = flatten(jax_from_variables(
        {n: p.grad for n, p in tm.named_parameters()}))
    ref = flatten(jax.tree.map(np.asarray, ref_grads))
    assert sorted(got) == sorted(ref)
    largest = max(float(np.abs(g).max()) for g in ref.values())
    for k in ref:
        if k[-2:] == ("k", "bias"):
            assert max(np.abs(got[k]).max(), np.abs(ref[k]).max()) <= \
                GRAD_TOL * largest, k
            continue
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= GRAD_TOL * scale, ("/".join(k), err, scale)
    # the tied head: the token table's gradient holds the LM head's part
    assert np.abs(got[("params", "tok_emb", "embedding")]).max() > 0


def test_adam_steps_match_optax():
    """tests/test_simbert.py's does-it-learn run, both sides from one
    initialisation: 31 steps of adam(3e-3) on one batch at dropout 0."""
    vocab_size, batch = _batch()
    jm, v, tm = _pair(vocab_size, batch["tok"], batch["seg"])
    jb = tp.to_jax(batch)
    opt = optax.adam(3e-3)
    jv = jax.tree.map(jnp.asarray, v)
    opt_state = opt.init(jv)

    @jax.jit
    def jstep(variables, opt_state):
        (loss, aux), grads = jax.value_and_grad(
            lambda w: jax_simbert_loss(jm, w, jb, training=False),
            has_aux=True)(variables)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(variables, updates), opt_state, loss

    topt = make_optimizer(3e-3, "adam").build(list(tm.named_parameters()))
    tb = tp.to_torch(batch)
    jl, tl = [], []
    for _ in range(31):
        jv, opt_state, loss = jstep(jv, opt_state)
        jl.append(float(loss))
        for p in tm.parameters():
            p.grad = None
        loss, _ = simbert_loss(tm, tb)
        loss.backward()
        topt.step()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=ADAM_TOL)
    assert tl[-1] < 0.7 * tl[0]
    got = flatten(jax_from_variables(tm.state_dict()))
    ref = flatten(jax.tree.map(np.asarray, jv))
    for k in ref:
        if k[-2:] == ("k", "bias"):
            continue
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ADAM_TOL,
                                   err_msg="/".join(k))
    ids, seg = batch["tok"], batch["seg"]
    np.testing.assert_allclose(
        _hidden(tm, ids, seg),
        np.asarray(jm.apply(jv, jnp.asarray(ids), jnp.asarray(seg),
                            seq2seq=True, return_sequence=True)),
        rtol=0, atol=ADAM_TOL)


def test_unilm_causality():
    """Position i's hidden state depends only on segment-0 tokens and the
    segment-1 tokens at positions <= i: a late segment-1 edit leaves every
    earlier position bitwise unchanged and moves its own."""
    ids = np.array([[2, 5, 6, 3, 7, 8, 9, 3]], np.int32)
    seg = np.array([[0, 0, 0, 0, 1, 1, 1, 1]], np.int32)
    _, _, tm = _pair(64, ids, seg)
    h1 = _hidden(tm, ids, seg)
    ids2 = ids.copy()
    ids2[0, 6] = 12
    h2 = _hidden(tm, ids2, seg)
    np.testing.assert_array_equal(h1[0, :6], h2[0, :6])
    assert np.abs(h1[0, 6] - h2[0, 6]).max() > 1e-4
    # without the mask the edit reaches back
    with torch.no_grad():
        b1, b2 = (tm(torch.from_numpy(x), torch.from_numpy(seg),
                     return_sequence=True).numpy() for x in (ids, ids2))
    assert np.abs(b1[0, :6] - b2[0, :6]).max() > 1e-4


def test_cls_blind_to_the_target_sentence():
    """hidden[:, 0] (simbert_loss's similarity vector) ignores segment-1
    edits and follows segment-0 edits."""
    vocab_size, batch = _batch(batch_size=4)
    ids, seg = batch["tok"], batch["seg"]
    _, _, tm = _pair(vocab_size, ids, seg)
    h1 = _hidden(tm, ids, seg)
    pos = int(np.argmax(seg[0] == 1))
    ids2 = ids.copy()
    ids2[0, pos] = (int(ids[0, pos]) % (vocab_size - 5)) + 5
    np.testing.assert_array_equal(_hidden(tm, ids2, seg)[0, 0], h1[0, 0])
    ids3 = ids.copy()
    ids3[0, 1] = (int(ids[0, 1]) % (vocab_size - 5)) + 5
    assert np.abs(_hidden(tm, ids3, seg)[0, 0] - h1[0, 0]).max() > 1e-4


def test_batches_equal_jax_and_dropout_follows_the_seed():
    """The port's simbert_batches equal the JAX generator's; in train mode
    the same seed draws the same dropout masks, another seed other ones."""
    vocab = build_demo_vocab(WORDS)
    got = list(simbert_batches(PAIRS, Tokenizer(vocab), 4, 8, seed=3))
    ref = list(jax_simbert_batches(PAIRS, JaxTokenizer(vocab), 4, 8, seed=3))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        for k in r:
            np.testing.assert_array_equal(g[k], r[k])
    tm = TextEncoder(len(vocab), num_layers=2, model_dim=32, num_heads=2,
                     ffn_hidden=64, max_len=16, dropout=0.3, device="cpu")
    tm.train()
    tb = tp.to_torch(got[0])
    with torch.no_grad():
        a, b, c = (float(simbert_loss(tm, tb, seed=s)[0]) for s in (7, 7, 8))
    assert a == b and a != c
