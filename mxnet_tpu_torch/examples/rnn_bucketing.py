"""Bucketed RNN training, the port's copy of examples/rnn_bucketing.py
(the reference's example/rnn/bucketing/lstm_bucketing.py):

    python -m mxnet_tpu_torch.examples.rnn_bucketing
    python -m mxnet_tpu_torch.examples.rnn_bucketing --cells \\
        --vocab 10000 --num-embed 200 --num-hidden 200 --batch-size 32

Sequences grouped into length buckets train an LSTM language model
through a ``BucketingModule``: one executor (one compiled graph) a
bucket, every bucket on the same parameters.  By default, as the JAX
example, the symbol is the hand-unrolled LSTM of ``make_sym_gen`` over
``BucketSeqIter``'s synthetic Markov sequences.  ``--cells`` builds it
instead from ``mx.rnn``: a ``SequentialRNNCell`` of two
``LSTMCell``s unrolled over the embedding, fed by ``mx.rnn.
BucketSentenceIter`` over ``SENTENCES`` of ``markov_sentences`` (the
reference example's structure).  The same flags as the JAX example,
plus ``--cells`` and ``--cpu``; everything runs on ``gpu(0)`` unless
``--cpu`` (or a ``ctx``) is given.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.io.io import DataBatch

__all__ = ["BucketSeqIter", "make_sym_gen", "markov_sentences",
           "make_cell_sym_gen", "parse_args", "build_module", "train",
           "main"]

SENTENCES = 2000     # the --cells corpus: about 60 batches of 32 an epoch


class BucketSeqIter(mx.io.DataIter):
    """The JAX example's synthetic Markov sequences bucketed by length:
    each batch holds (data, label) of exactly ``bucket_key`` tokens."""

    def __init__(self, vocab, buckets, batch_size, batches_per_bucket=8,
                 seed=7):
        super().__init__(batch_size)
        self.buckets = sorted(buckets)
        self.vocab = vocab
        self.batch_size = batch_size
        self.default_bucket_key = max(self.buckets)
        rng = np.random.RandomState(seed)
        nxt = (np.arange(vocab) * 5 + 1) % vocab
        self._batches = []
        for blen in self.buckets:
            for _ in range(batches_per_bucket):
                seq = np.empty((batch_size, blen + 1), np.int64)
                seq[:, 0] = rng.randint(vocab, size=batch_size)
                for t in range(1, blen + 1):
                    take = rng.rand(batch_size) < 0.85
                    seq[:, t] = np.where(take, nxt[seq[:, t - 1]],
                                         rng.randint(vocab,
                                                     size=batch_size))
                self._batches.append((blen, seq))
        rng.shuffle(self._batches)
        self._pos = 0

    @property
    def provide_data(self):
        return [("data", (self.batch_size, self.default_bucket_key))]

    @property
    def provide_label(self):
        return [("softmax_label",
                 (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self._pos = 0

    def next(self):
        if self._pos >= len(self._batches):
            raise StopIteration
        blen, seq = self._batches[self._pos]
        self._pos += 1
        batch = DataBatch(data=[mx.nd.array(seq[:, :-1])],
                          label=[mx.nd.array(seq[:, 1:])])
        batch.bucket_key = blen
        batch.provide_data = [("data", (self.batch_size, blen))]
        batch.provide_label = [("softmax_label", (self.batch_size, blen))]
        return batch


def make_sym_gen(vocab, num_embed, num_hidden):
    """The JAX example's per-length LSTM LM symbol, unrolled by hand:
    the same named weights in every step and every bucket."""

    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        i2h_w = mx.sym.var("lstm_i2h_weight")
        i2h_b = mx.sym.var("lstm_i2h_bias")
        h2h_w = mx.sym.var("lstm_h2h_weight")
        h2h_b = mx.sym.var("lstm_h2h_bias")

        emb = mx.sym.Embedding(data, input_dim=vocab,
                               output_dim=num_embed, name="embed")
        steps = mx.sym.SliceChannel(emb, num_outputs=seq_len, axis=1,
                                    squeeze_axis=True)
        h = c = None
        outs = []
        for t in range(seq_len):
            gates = mx.sym.FullyConnected(
                steps[t], weight=i2h_w, bias=i2h_b,
                num_hidden=4 * num_hidden, name="i2h_t%d" % t)
            if h is not None:
                gates = gates + mx.sym.FullyConnected(
                    h, weight=h2h_w, bias=h2h_b,
                    num_hidden=4 * num_hidden, name="h2h_t%d" % t)
            sl = mx.sym.SliceChannel(gates, num_outputs=4, axis=1)
            i = mx.sym.sigmoid(sl[0])
            f = mx.sym.sigmoid(sl[1])
            g = mx.sym.tanh(sl[2])
            o = mx.sym.sigmoid(sl[3])
            c = g * i if c is None else f * c + i * g
            h = o * mx.sym.tanh(c)
            outs.append(mx.sym.Reshape(h, shape=(0, 1, num_hidden)))
        seq = mx.sym.Concat(*outs, dim=1)
        flat = mx.sym.Reshape(seq, shape=(-1, num_hidden))
        fc = mx.sym.FullyConnected(flat, num_hidden=vocab, name="fc")
        lab = mx.sym.Reshape(label, shape=(-1,))
        sm = mx.sym.SoftmaxOutput(fc, lab, name="softmax")
        return sm, ("data",), ("softmax_label",)

    return sym_gen


def markov_sentences(vocab, n, min_len, max_len, seed=7):
    """``n`` token lists of ``min_len``..``max_len`` words over ids
    1..vocab-1 (0 pads): each next word is (word * 5 + 1) mod the id
    range with probability 0.85, else a draw from a Zipf law (p(k) ~
    1 / (k + 1)) as a sentence's first word is: word frequencies as
    skewed as a text's, so the perplexity falls from the first batches
    on."""
    rng = np.random.RandomState(seed)
    ids = vocab - 1
    zipf = 1.0 / np.arange(1, ids + 1)
    zipf /= zipf.sum()
    out = []
    for _ in range(n):
        length = rng.randint(min_len, max_len + 1)
        draws = rng.choice(ids, size=length, p=zipf)
        w = [int(draws[0])]
        for t in range(1, length):
            w.append((w[-1] * 5 + 1) % ids if rng.rand() < 0.85
                     else int(draws[t]))
        out.append([x + 1 for x in w])
    return out


def make_cell_sym_gen(vocab, num_embed, num_hidden, batch_size):
    """The reference example's symbol: Embedding, a SequentialRNNCell of
    two mx.rnn.LSTMCells (its default depth) unrolled over it (zero
    begin states), FullyConnected and SoftmaxOutput, which here ignores
    the padding label 0."""
    stack = mx.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(mx.rnn.LSTMCell(num_hidden, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab,
                                 output_dim=num_embed, name="embed")
        stack.reset()
        begin = stack.begin_state(func=mx.sym.zeros,
                                  shape=(batch_size, num_hidden))
        outputs, _ = stack.unroll(seq_len, inputs=embed, begin_state=begin,
                                  merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        lab = mx.sym.Reshape(label, shape=(-1,))
        # padding (label 0) takes no gradient, so the model does not
        # learn to predict it (Perplexity leaves it out too)
        sm = mx.sym.SoftmaxOutput(pred, lab, use_ignore=True,
                                  ignore_label=0, name="softmax")
        return sm, ("data",), ("softmax_label",)

    return sym_gen


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--num-embed", type=int, default=32)
    p.add_argument("--num-hidden", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--buckets", default="8,16,24")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--cells", action="store_true",
                   help="build the symbol from mx.rnn cells")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def _ctx(args, ctx):
    if ctx is not None:
        return ctx
    return mx.cpu() if args.cpu else mx.gpu(0)


def data_iter(args):
    """The training iterator; it makes each batch on the current
    context."""
    buckets = [int(b) for b in args.buckets.split(",")]
    if not args.cells:
        return BucketSeqIter(args.vocab, buckets, args.batch_size)
    sents = markov_sentences(args.vocab, SENTENCES, 2, max(buckets))
    return mx.rnn.BucketSentenceIter(sents, args.batch_size,
                                     buckets=buckets, invalid_label=0)


def build_module(args, it, ctx, arg_params=None):
    """A bound BucketingModule with Xavier (or ``arg_params``) and sgd
    (momentum 0.9)."""
    if args.cells:
        sym_gen = make_cell_sym_gen(args.vocab, args.num_embed,
                                    args.num_hidden, args.batch_size)
    else:
        sym_gen = make_sym_gen(args.vocab, args.num_embed, args.num_hidden)
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.init.Xavier(), arg_params=arg_params,
                    allow_missing=arg_params is None)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": args.lr,
                                         "momentum": 0.9})
    return mod


def train(args, ctx=None, arg_params=None, max_batches=None,
          keep_outputs=False):
    """``args.epochs`` epochs (or ``max_batches`` batches).  Returns a
    dict: ``ppl`` (each epoch's training perplexity), ``batch_ppl``
    (each batch's), ``batch_s`` (each batch's seconds, ending in a
    device synchronize), ``buckets`` (each batch's bucket key),
    ``outputs`` (with ``keep_outputs``, each batch's softmax, read after
    the loop), the ``module`` and the iterator ``it``."""
    ctx = _ctx(args, ctx)
    it = data_iter(args)
    mod = build_module(args, it, ctx, arg_params)
    ignore = 0 if args.cells else None
    metric = mx.metric.Perplexity(ignore_label=ignore)
    batch_metric = mx.metric.Perplexity(ignore_label=ignore)
    sync = torch.cuda.synchronize if ctx.device_type == "gpu" \
        else (lambda: None)
    ppl, batch_ppl, batch_s, buckets, outputs = [], [], [], [], []
    for epoch in range(args.epochs):
        it.reset()
        metric.reset()
        tic = time.time()
        while max_batches is None or len(batch_s) < max_batches:
            with ctx:   # the iterators make their batches here
                batch = next(it, None)
            if batch is None:
                break
            t0 = time.perf_counter()
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            mod.update_metric(metric, batch.label)
            sync()
            batch_s.append(time.perf_counter() - t0)
            buckets.append(batch.bucket_key)
            batch_metric.reset()
            mod.update_metric(batch_metric, batch.label)
            batch_ppl.append(batch_metric.get()[1])
            if keep_outputs:
                outputs.append(mod.get_outputs()[0].asnumpy())
        ppl.append(metric.get()[1])
        logging.info("epoch %d  %s  (%.1fs)", epoch, metric.get(),
                     time.time() - tic)
        if max_batches is not None and len(batch_s) == max_batches:
            break
    return {"ppl": ppl, "batch_ppl": batch_ppl, "batch_s": batch_s,
            "buckets": buckets, "outputs": outputs, "module": mod,
            "it": it}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    res = train(args)
    print("final perplexity: %.2f (random = %d)" % (res["ppl"][-1],
                                                    args.vocab))
    return res["ppl"][-1]


if __name__ == "__main__":
    main()
