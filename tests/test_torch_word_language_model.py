"""The port's examples/word_language_model.py and rnn_bucketing.py
(mxnet_tpu_torch/examples/) held against the JAX examples' own
functions on the CPU, at a small size: vocabulary 50, emsize 16, nhid
24, 2 layers, bptt 5, batch 4, dropout 0 (the parity runs; both
packages draw dropout from their own generators).

* word LM: the JAX example's ``RNNModel`` (hybridized, as its main()
  runs it), ``synthetic_corpus`` and ``batchify`` drive its training loop
  for 3 steps (sgd lr 20, clip 0.25); the port's ``train`` does the same
  from the same weights (``convert.load_from_numpy``); the losses agree
  at rtol 1e-5, and so do the weights after the 3 updates (rtol 1e-4,
  atol 1e-5: lr 20 multiplies f32 gradient noise).  Also: in the LSTM,
  GRU and RNN modes (lr 1) the port hybridized and eager give the same
  losses at each of 3 steps.
* bucketing: the JAX example's ``make_sym_gen`` and ``BucketSeqIter``
  through a ``BucketingModule`` for 3 batches against the port's
  ``train`` from the same initial parameters (softmax outputs at rtol
  1e-5, atol 1e-6); ``--cells`` against the same ``mx.rnn`` stack built
  with the JAX package's cells, also 3 batches.
JAX matmuls at ``default_matmul_precision("float32")``, torch at
``"highest"``; the port compiles with ``aot_eager``."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from examples import rnn_bucketing as jbuck
from examples import word_language_model as jwlm

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples import rnn_bucketing as tbuck
from mxnet_tpu_torch.examples import word_language_model as twlm

SMALL = ["--vocab", "50", "--emsize", "16", "--nhid", "24", "--nlayers",
         "2", "--bptt", "5", "--batch-size", "4", "--dropout", "0",
         "--epochs", "1", "--corpus-len", "2000", "--cpu"]


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _jax_lm(args, steps):
    """The JAX example's loop (examples/word_language_model.py main()),
    ``steps`` steps; returns the losses, the weights before and after."""
    jmx.random.seed(0)
    with jmx.name.NameManager():
        model = jwlm.RNNModel(args.model, args.vocab, args.emsize,
                              args.nhid, args.nlayers, dropout=args.dropout)
    model.initialize(jmx.init.Xavier())
    x0 = jmx.nd.array(np.zeros((args.bptt, args.batch_size), np.float32))
    with jmx.autograd.pause():
        model(x0, *model.begin_state(args.batch_size))
    rng = np.random.RandomState(11)
    init = {}
    for name, p in sorted(model.collect_params().items()):
        v = (rng.randn(*p.data().shape) * 0.1).astype(np.float32)
        p.set_data(jmx.nd.array(v))
        init[name] = v
    model.hybridize()
    data = jwlm.batchify(jwlm.synthetic_corpus(args.vocab, args.corpus_len),
                         args.batch_size)
    trainer = jmx.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": args.lr,
                                 "clip_gradient": args.clip})
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    states = model.begin_state(args.batch_size)
    losses = []
    for i in range(0, steps * args.bptt, args.bptt):
        x = jmx.nd.array(data[i:i + args.bptt])
        y = jmx.nd.array(data[i + 1:i + 1 + args.bptt])
        states = [s.detach() for s in states]
        with jmx.autograd.record():
            out, states = model(x, *states)
            loss = loss_fn(out.reshape((-1, args.vocab)), y.reshape((-1,)))
        loss.backward()
        trainer.step(args.batch_size * args.bptt)
        losses.append(float(loss.mean().asnumpy()))
    after = {n: p.data().asnumpy() for n, p in model.collect_params().items()}
    return np.array(losses), init, after


def test_word_language_model_against_jax():
    args = twlm.parse_args(SMALL)
    want, init, after = _jax_lm(args, 3)
    with tmx.name.NameManager():
        model = twlm.build(args, tmx.cpu(), weights=init)
    res = twlm.train(args, ctx=tmx.cpu(), model=model, max_steps=3)
    assert len(model._cached_op._compiled) == 1
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5)
    got = {n: p.data().asnumpy() for n, p in model.collect_params().items()}
    for n in after:
        np.testing.assert_allclose(got[n], after[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn"])
def test_word_language_model_hybridized_equals_eager(mode):
    # lr 1: at the example's lr 20 the relu RNN diverges within 3 steps
    args = twlm.parse_args(SMALL + ["--model", mode, "--lr", "1"])
    with tmx.name.NameManager():
        ref = twlm.build(args, tmx.cpu())
    x0 = tmx.nd.zeros((args.bptt, args.batch_size), ctx=tmx.cpu())
    with tmx.autograd.pause():
        ref(x0, *ref.begin_state(args.batch_size, ctx=tmx.cpu()))
    weights = {n: p.data().asnumpy() for n, p in
               ref.collect_params().items()}
    runs = []
    for hyb in (False, True):
        with tmx.name.NameManager():
            model = twlm.build(args, tmx.cpu(), weights=weights)
        runs.append(twlm.train(args, ctx=tmx.cpu(), model=model,
                               hybridize=hyb, max_steps=3)["losses"])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)
    assert np.isfinite(runs[0]).all()


BUCKET = ["--vocab", "50", "--num-embed", "16", "--num-hidden", "24",
          "--batch-size", "4", "--buckets", "4,6", "--epochs", "1",
          "--cpu"]


def _jax_bucketing(sym_gen, it, arg_params, batches):
    mod = jmx.mod.BucketingModule(sym_gen,
                                  default_bucket_key=it.default_bucket_key)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(jmx.init.Xavier(), arg_params=arg_params)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.2,
                                         "momentum": 0.9})
    outs, keys = [], []
    it.reset()   # as the JAX example's epoch loop does
    for batch in it:
        if len(outs) == batches:
            break
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
        keys.append(batch.bucket_key)
    return outs, keys


def _init_params(sym, shapes, seed=2):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def test_rnn_bucketing_against_jax():
    args = tbuck.parse_args(BUCKET)
    buckets = [4, 6]
    jit = jbuck.BucketSeqIter(args.vocab, buckets, args.batch_size)
    jgen = jbuck.make_sym_gen(args.vocab, args.num_embed, args.num_hidden)
    sym, _, _ = jgen(6)
    init = _init_params(sym, {"data": (4, 6), "softmax_label": (4, 6)})
    want, keys = _jax_bucketing(jgen, jit, {n: jmx.nd.array(v)
                                            for n, v in init.items()}, 3)
    res = tbuck.train(args, ctx=tmx.cpu(),
                      arg_params={n: tmx.nd.array(v, ctx=tmx.cpu())
                                  for n, v in init.items()}, max_batches=3,
                      keep_outputs=True)
    assert res["buckets"] == keys
    for g, w in zip(res["outputs"], want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_rnn_bucketing_cells_against_jax():
    args = tbuck.parse_args(BUCKET + ["--cells"])

    def jax_sym_gen(seq_len):
        stack = jmx.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(jmx.rnn.LSTMCell(args.num_hidden,
                                       prefix="lstm_l%d_" % i))
        data = jmx.sym.var("data")
        label = jmx.sym.var("softmax_label")
        embed = jmx.sym.Embedding(data, input_dim=args.vocab,
                                  output_dim=args.num_embed, name="embed")
        begin = stack.begin_state(func=jmx.sym.zeros,
                                  shape=(args.batch_size, args.num_hidden))
        outputs, _ = stack.unroll(seq_len, inputs=embed, begin_state=begin,
                                  merge_outputs=True)
        pred = jmx.sym.Reshape(outputs, shape=(-1, args.num_hidden))
        pred = jmx.sym.FullyConnected(pred, num_hidden=args.vocab,
                                      name="pred")
        lab = jmx.sym.Reshape(label, shape=(-1,))
        return (jmx.sym.SoftmaxOutput(pred, lab, use_ignore=True,
                                      ignore_label=0, name="softmax"),
                ("data",), ("softmax_label",))

    sents = tbuck.markov_sentences(args.vocab, tbuck.SENTENCES, 2, 6)
    jit = jmx.rnn.BucketSentenceIter(sents, args.batch_size, buckets=[4, 6],
                                     invalid_label=0)
    sym, _, _ = jax_sym_gen(6)
    tsym, _, _ = tbuck.make_cell_sym_gen(
        args.vocab, args.num_embed, args.num_hidden, args.batch_size)(6)
    assert tsym.list_arguments() == sym.list_arguments()
    init = _init_params(sym, {"data": (4, 6), "softmax_label": (4, 6)})
    want, keys = _jax_bucketing(jax_sym_gen, jit, {
        n: jmx.nd.array(v) for n, v in init.items()}, 3)
    res = tbuck.train(args, ctx=tmx.cpu(),
                      arg_params={n: tmx.nd.array(v, ctx=tmx.cpu())
                                  for n, v in init.items()}, max_batches=3,
                      keep_outputs=True)
    assert res["buckets"] == keys
    for g, w in zip(res["outputs"], want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
