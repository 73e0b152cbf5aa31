"""LSTM/GRU word language model, the port's copy of
examples/word_language_model.py (the reference's
example/gluon/word_language_model/train.py):

    python -m mxnet_tpu_torch.examples.word_language_model \\
        --vocab 33278 --emsize 650 --nhid 650 --dropout 0.2

An Embedding -> (LSTM|GRU|RNN) -> Dense decoder trained with truncated
BPTT (sgd, ``--lr``, gradients clipped at ``--clip``), the model
hybridized as the JAX example hybridizes it.  ``--data`` names a
whitespace-tokenized text file; without one the example's seeded Markov
corpus (``synthetic_corpus``) stands in, at ``--vocab`` words.  The same
flags as the JAX example, plus ``--dropout`` (default the example's 0.2)
and ``--cpu``; everything runs on ``gpu(0)`` unless ``--cpu`` (or a
``ctx``) is given.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn, rnn

__all__ = ["RNNModel", "synthetic_corpus", "batchify", "parse_args",
           "corpus", "build", "make_step", "train", "main"]


class RNNModel(gluon.HybridBlock):
    """Embedding -> dropout -> RNN -> dropout -> vocabulary projection."""

    def __init__(self, mode, vocab_size, num_embed, num_hidden, num_layers,
                 dropout=0.2, **kwargs):
        super().__init__(**kwargs)
        self.num_hidden = num_hidden
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, num_embed)
            if mode == "lstm":
                self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                    input_size=num_embed)
            elif mode == "gru":
                self.rnn = rnn.GRU(num_hidden, num_layers, dropout=dropout,
                                   input_size=num_embed)
            else:
                self.rnn = rnn.RNN(num_hidden, num_layers, dropout=dropout,
                                   input_size=num_embed)
            self.decoder = nn.Dense(vocab_size, flatten=False)

    def hybrid_forward(self, F, inputs, *states):
        emb = self.drop(self.encoder(inputs))
        output, states = self.rnn(emb, list(states))
        decoded = self.decoder(self.drop(output))
        return decoded, states

    def begin_state(self, batch_size, ctx=None):
        return self.rnn.begin_state(batch_size=batch_size, ctx=ctx)


def synthetic_corpus(vocab_size, length, seed=17):
    """The JAX example's Markov chain: each token prefers
    (token * 7 + 3) % vocab, so the perplexity falls as the model
    learns."""
    rng = np.random.RandomState(seed)
    toks = np.empty(length, np.int64)
    toks[0] = 0
    nxt = (np.arange(vocab_size) * 7 + 3) % vocab_size
    for i in range(1, length):
        if rng.rand() < 0.8:
            toks[i] = nxt[toks[i - 1]]
        else:
            toks[i] = rng.randint(vocab_size)
    return toks


def batchify(data, batch_size):
    nbatch = len(data) // batch_size
    return data[:nbatch * batch_size].reshape(batch_size, nbatch).T


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="lstm", choices=["lstm", "gru", "rnn"])
    p.add_argument("--vocab", type=int, default=200)
    p.add_argument("--emsize", type=int, default=128)
    p.add_argument("--nhid", type=int, default=256)
    p.add_argument("--nlayers", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--bptt", type=int, default=35)
    p.add_argument("--lr", type=float, default=20.0)
    p.add_argument("--clip", type=float, default=0.25)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--corpus-len", type=int, default=60000)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--data", default=None,
                   help="whitespace-tokenized text file (optional)")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def _ctx(args, ctx):
    if ctx is not None:
        return ctx
    return mx.cpu() if args.cpu else mx.gpu(0)


def corpus(args):
    """(T, batch) token ids: ``--data``'s words, else the synthetic
    corpus; sets ``args.vocab`` from a file."""
    if args.data and os.path.exists(args.data):
        with open(args.data) as f:
            words = f.read().split()
        vocab = {w: i for i, w in enumerate(dict.fromkeys(words))}
        toks = np.array([vocab[w] for w in words], np.int64)
        args.vocab = len(vocab)
    else:
        toks = synthetic_corpus(args.vocab, args.corpus_len)
    return batchify(toks, args.batch_size)


def build(args, ctx, weights=None):
    """The model on ``ctx``: Xavier, or ``weights`` ({name: numpy})."""
    model = RNNModel(args.model, args.vocab, args.emsize, args.nhid,
                     args.nlayers, dropout=args.dropout)
    model.initialize(mx.init.Xavier(), ctx=ctx)
    if weights is not None:
        mx.convert.load_from_numpy(model, weights)
    return model


def make_step(args, model, trainer, loss_fn):
    """One truncated-BPTT step: ``step(x, y, states) -> (loss, states)``,
    the states detached at the segment boundary, then forward, backward
    and the trainer's update."""
    def step(x, y, states):
        states = [s.detach() for s in states]
        with autograd.record():
            out, states = model(x, *states)
            loss = loss_fn(out.reshape((-1, args.vocab)), y.reshape((-1,)))
        loss.backward()
        trainer.step(args.batch_size * args.bptt)
        return loss, states
    return step


def train(args, ctx=None, model=None, hybridize=True, max_steps=None):
    """The example's loop for ``args.epochs`` epochs (or ``max_steps``
    steps).  Returns a dict: ``losses`` (each step's mean loss, read after
    the loop), ``step_s`` (each step's seconds, ending in a device
    synchronize), ``ppl`` (each epoch's perplexity), the ``model``, and
    ``step``, ``states`` and ``data`` to run more steps."""
    ctx = _ctx(args, ctx)
    data = corpus(args)
    if model is None:
        model = build(args, ctx)
    if hybridize:
        model.hybridize()
    trainer = gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": args.lr,
                             "clip_gradient": args.clip})
    step = make_step(args, model, trainer,
                     gluon.loss.SoftmaxCrossEntropyLoss())
    sync = torch.cuda.synchronize if ctx.device_type == "gpu" \
        else (lambda: None)
    losses, step_s, ppl = [], [], []
    for epoch in range(args.epochs):
        states = model.begin_state(args.batch_size, ctx=ctx)
        total, n_tok, tic = [], 0, time.time()
        for i in range(0, data.shape[0] - 1 - args.bptt, args.bptt):
            if max_steps is not None and len(losses) == max_steps:
                break
            t0 = time.perf_counter()
            x = mx.nd.array(data[i:i + args.bptt], ctx=ctx)
            y = mx.nd.array(data[i + 1:i + 1 + args.bptt], ctx=ctx)
            loss, states = step(x, y, states)
            sync()
            step_s.append(time.perf_counter() - t0)
            mean = loss.mean()._data
            losses.append(mean)
            total.append(mean * x.size)
            n_tok += x.size
        if n_tok:
            mean_loss = float(sum(total)) / n_tok
            ppl.append(math.exp(mean_loss) if mean_loss < 700
                       else float("inf"))
            logging.info("epoch %d  perplexity %.2f  (%.1fs, %d tok/s)",
                         epoch, ppl[-1], time.time() - tic,
                         int(n_tok / max(time.time() - tic, 1e-9)))
        if max_steps is not None and len(losses) == max_steps:
            break
    return {"losses": np.array([float(v) for v in losses]),
            "step_s": step_s, "ppl": ppl, "model": model, "step": step,
            "states": states, "data": data}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    res = train(args)
    print("final perplexity: %.2f (random = %.2f)"
          % (res["ppl"][-1], float(args.vocab)))
    return res["ppl"][-1]


if __name__ == "__main__":
    main()
