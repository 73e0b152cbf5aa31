"""Gluon contrib data: IntervalSampler and the WikiText language-model
datasets (parity: mxnet_tpu/gluon/contrib/data.py; the reference's
python/mxnet/gluon/contrib/data/sampler.py and text.py).

The WikiText classes read a ``wiki.<segment>.tokens`` file already in
``root`` (the file the reference's downloader unzips there) and raise
when it is absent; they download nothing.  The vocabulary is the JAX
package's ``contrib.text`` one (index 0 ``<unk>``, then ``<eos>``, then
the tokens by falling frequency, ties alphabetical), kept here as
``_Vocabulary`` since ``contrib.text`` is not ported."""
from __future__ import annotations

import io
import os
import re
from collections import Counter

import numpy as np

from ..data import dataset, sampler
from ... import ndarray as nd
from ...base import MXNetError
from ...context import cpu

__all__ = ["IntervalSampler", "WikiText2", "WikiText103"]

EOS_TOKEN = "<eos>"


class IntervalSampler(sampler.Sampler):
    """Visit [0, length) with stride `interval`, starting a new pass at
    each successive offset when `rollover` (reference: sampler.py:25)."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length, \
            "interval %d must be <= length %d" % (interval, length)
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        offsets = range(self._interval) if self._rollover else range(1)
        for off in offsets:
            yield from range(off, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))


class _Vocabulary:
    """Token <-> index maps: index 0 ``<unk>``, then ``reserved``, then
    the counter's tokens by falling frequency, ties alphabetical (the JAX
    package's ``contrib.text.vocab.Vocabulary`` with its defaults)."""

    def __init__(self, counter, reserved):
        self.idx_to_token = ["<unk>"] + list(reserved)
        skip = set(self.idx_to_token)
        self.idx_to_token += [t for t, _ in sorted(
            counter.items(), key=lambda kv: (-kv[1], kv[0])) if t not in skip]
        self.token_to_idx = {t: i for i, t in enumerate(self.idx_to_token)}

    def __len__(self):
        return len(self.idx_to_token)

    def to_indices(self, tokens):
        """Token(s) -> index(es); an unknown token maps to 0."""
        if isinstance(tokens, str):
            return self.token_to_idx.get(tokens, 0)
        return [self.token_to_idx.get(t, 0) for t in tokens]

    def to_tokens(self, indices):
        if isinstance(indices, (list, tuple)):
            return [self.idx_to_token[int(i)] for i in indices]
        return self.idx_to_token[int(indices)]


class _WikiText(dataset.Dataset):
    """Word-level LM dataset over a local wikitext token file: the token
    stream (with <eos> closing each line) becomes (data, label) sample
    pairs of `seq_len`, label shifted one token ahead (reference:
    text.py:58)."""

    _namespace = None        # e.g. "wikitext-2"
    _token_files = {}        # segment -> filename

    def __init__(self, root, segment="train", vocab=None, seq_len=35):
        self._root = os.path.expanduser(root)
        self._segment = segment
        self._seq_len = seq_len
        self._vocab = vocab
        self._counter = None
        self._load()

    @property
    def vocabulary(self):
        return self._vocab

    @property
    def frequencies(self):
        return self._counter

    def _load(self):
        fname = self._token_files[self._segment]
        path = os.path.join(self._root, fname)
        if not os.path.exists(path):
            raise MXNetError(
                "%s: token file %s not found; nothing is downloaded: "
                "place the extracted %s archive's %s in %s"
                % (type(self).__name__, path, self._namespace, fname,
                   self._root))
        with io.open(path, "r", encoding="utf8") as f:
            content = f.read()
        tokens = []
        for line in content.splitlines():
            words = line.strip().split()
            if words:
                tokens.extend(words)
                tokens.append(EOS_TOKEN)
        if self._counter is None:
            self._counter = Counter(
                t for t in re.sub("\n", " ", content).split(" ") if t)
        if self._vocab is None:
            self._vocab = _Vocabulary(self._counter, [EOS_TOKEN])
        ids = np.asarray(self._vocab.to_indices(tokens), dtype=np.int32)
        n = (len(ids) - 1) // self._seq_len
        # host arrays, as every dataset's: a DataLoader moves batches
        self._data = nd.array(
            ids[:n * self._seq_len].reshape(n, self._seq_len), ctx=cpu())
        self._label = nd.array(
            ids[1:n * self._seq_len + 1].reshape(n, self._seq_len),
            ctx=cpu())

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)


class WikiText2(_WikiText):
    """WikiText-2 (reference: text.py:105)."""

    _namespace = "wikitext-2"
    _token_files = {"train": "wiki.train.tokens",
                    "validation": "wiki.valid.tokens",
                    "test": "wiki.test.tokens"}

    def __init__(self, root=None, segment="train", vocab=None, seq_len=35):
        if root is None:
            root = os.path.join(os.environ.get("MXNET_HOME", "~/.mxnet"),
                                "datasets", "wikitext-2")
        super().__init__(root, segment, vocab, seq_len)


class WikiText103(_WikiText):
    """WikiText-103 (reference: text.py:143)."""

    _namespace = "wikitext-103"
    _token_files = {"train": "wiki.train.tokens",
                    "validation": "wiki.valid.tokens",
                    "test": "wiki.test.tokens"}

    def __init__(self, root=None, segment="train", vocab=None, seq_len=35):
        if root is None:
            root = os.path.join(os.environ.get("MXNET_HOME", "~/.mxnet"),
                                "datasets", "wikitext-103")
        super().__init__(root, segment, vocab, seq_len)
