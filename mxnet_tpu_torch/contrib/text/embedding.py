"""Token embeddings (parity: mxnet_tpu/contrib/text/embedding.py;
python/mxnet/contrib/text/embedding.py): the TokenEmbedding contract
(the ``idx_to_vec`` table, ``get_vecs_by_tokens``,
``update_token_vectors``, ``register`` / ``create``) and
CustomEmbedding's ``token<delim>v1<delim>...`` file format.  The
pretrained families (GloVe, fastText) register here too and read their
files from a local directory only: nothing is downloaded.  A table lies
on the context current when it is made (``gpu(0)`` unless a ``with
mx.cpu():`` scope says otherwise).
"""
from __future__ import annotations

import io
import logging
import os

import numpy as np
import torch

from ...ndarray.ndarray import NDArray, array
from .vocab import Vocabulary

__all__ = ["register", "create", "get_pretrained_file_names",
           "TokenEmbedding", "CustomEmbedding", "GloVe", "FastText",
           "CompositeEmbedding"]

_REGISTRY = {}


def register(cls):
    """Decorator registering a TokenEmbedding subclass by lowercase name."""
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(embedding_name, **kwargs):
    name = embedding_name.lower()
    if name not in _REGISTRY:
        raise KeyError("embedding %r is not registered (have: %s)"
                       % (embedding_name, sorted(_REGISTRY)))
    return _REGISTRY[name](**kwargs)


def get_pretrained_file_names(embedding_name=None):
    if embedding_name is not None:
        return list(_REGISTRY[embedding_name.lower()]
                    .pretrained_file_names)
    return {n: list(c.pretrained_file_names)
            for n, c in _REGISTRY.items()}


class TokenEmbedding:
    """Index -> vector table aligned with a token index map."""

    pretrained_file_names = ()

    def __init__(self, unknown_token="<unk>", init_unknown_vec=None):
        self._unknown_token = unknown_token
        self._init_unknown_vec = init_unknown_vec or (lambda s: np.zeros(
            s, np.float32))
        self._idx_to_token = [unknown_token]
        self._token_to_idx = {unknown_token: 0}
        self._idx_to_vec = None        # NDArray (n, dim)

    # -- loading --------------------------------------------------------
    def _load_embedding_file(self, path, elem_delim):
        """Parse token<delim>floats lines into the table."""
        def _intlike(x):
            try:
                int(x)
                return True
            except ValueError:
                return False

        vectors = []
        dim = None
        with io.open(path, "r", encoding="utf-8", errors="replace") as f:
            for lineno, line in enumerate(f):
                parts = line.rstrip().split(elem_delim)
                if len(parts) < 2:
                    continue
                if lineno == 0 and len(parts) == 2 and \
                        all(_intlike(p) for p in parts):
                    continue  # fastText-style "count dim" header
                token, elems = parts[0], parts[1:]
                if dim is None:
                    dim = len(elems)
                if len(elems) != dim:
                    logging.warning("line %d of %s: expected %s floats",
                                    lineno + 1, path, dim)
                    continue
                if token in self._token_to_idx:
                    continue
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)
                vectors.append(np.asarray([float(x) for x in elems],
                                          np.float32))
        if dim is None:
            raise ValueError("no embedding vectors found in %s" % path)
        table = np.vstack([self._init_unknown_vec((dim,))] + vectors) \
            if vectors else self._init_unknown_vec((1, dim))
        self._idx_to_vec = array(table.astype(np.float32))

    # -- contract -------------------------------------------------------
    @property
    def vec_len(self):
        return int(self._idx_to_vec.shape[1])

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def token_to_idx(self):
        return self._token_to_idx

    def __len__(self):
        return len(self._idx_to_token)

    def to_indices(self, tokens):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        single = not isinstance(indices, (list, tuple))
        idxs = [indices] if single else indices
        out = [self._idx_to_token[int(i)] for i in idxs]
        return out[0] if single else out

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idxs = []
        for t in toks:
            i = self._token_to_idx.get(t)
            if i is None and lower_case_backup:
                i = self._token_to_idx.get(t.lower())
            idxs.append(0 if i is None else i)
        table = self._idx_to_vec._data
        vecs = table[torch.as_tensor(idxs, device=table.device)]
        return NDArray(vecs[0] if single else vecs)

    def update_token_vectors(self, tokens, new_vectors):
        toks = [tokens] if isinstance(tokens, str) else tokens
        vals = new_vectors.asnumpy() if isinstance(new_vectors, NDArray) \
            else np.asarray(new_vectors, np.float32)
        vals = np.asarray(vals, np.float32).reshape(len(toks), -1)
        idxs = []
        for t in toks:
            if t not in self._token_to_idx:
                raise ValueError("token %r is not indexed" % t)
            idxs.append(self._token_to_idx[t])
        table = np.array(self._idx_to_vec.asnumpy())  # writable copy
        table[np.asarray(idxs)] = vals
        self._idx_to_vec = array(table, ctx=self._idx_to_vec.context)


@register
class CustomEmbedding(TokenEmbedding):
    """User-supplied embedding file: ``token<elem_delim>v1...`` lines."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf8", vocabulary=None, **kwargs):
        super().__init__(**kwargs)
        self._load_embedding_file(pretrained_file_path, elem_delim)
        if vocabulary is not None:
            self._restrict_to(vocabulary)

    def _restrict_to(self, vocab):
        table = np.asarray(self._idx_to_vec.asnumpy())
        rows = [table[self._token_to_idx.get(t, 0)]
                for t in vocab.idx_to_token]
        self._idx_to_token = list(vocab.idx_to_token)
        self._token_to_idx = dict(vocab.token_to_idx)
        self._idx_to_vec = array(np.vstack(rows).astype(np.float32))


class _FileBackedEmbedding(TokenEmbedding):
    """Pretrained families: the file is looked up in ``embedding_root``
    (default ``~/.mxnet/embeddings/<family>``); nothing is downloaded."""

    source_dir = ""

    def __init__(self, pretrained_file_name, embedding_root=None,
                 elem_delim=" ", **kwargs):
        super().__init__(**kwargs)
        root = embedding_root or os.path.join(
            os.path.expanduser("~"), ".mxnet", "embeddings",
            self.source_dir)
        path = os.path.join(root, pretrained_file_name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                "%s not found under %s; pretrained embeddings are read "
                "from local files only: place the file there or use "
                "CustomEmbedding" % (pretrained_file_name, root))
        self._load_embedding_file(path, elem_delim)


@register
class GloVe(_FileBackedEmbedding):
    source_dir = "glove"
    pretrained_file_names = (
        "glove.42B.300d.txt", "glove.6B.50d.txt", "glove.6B.100d.txt",
        "glove.6B.200d.txt", "glove.6B.300d.txt", "glove.840B.300d.txt",
        "glove.twitter.27B.25d.txt", "glove.twitter.27B.50d.txt",
        "glove.twitter.27B.100d.txt", "glove.twitter.27B.200d.txt")


@register
class FastText(_FileBackedEmbedding):
    source_dir = "fasttext"
    pretrained_file_names = ("wiki.en.vec", "wiki.simple.vec",
                             "crawl-300d-2M.vec")


class CompositeEmbedding(TokenEmbedding):
    """Concatenate several embeddings over one vocabulary."""

    def __init__(self, vocabulary, token_embeddings, **kwargs):
        if not isinstance(vocabulary, Vocabulary):
            raise TypeError("vocabulary must be a Vocabulary")
        if isinstance(token_embeddings, TokenEmbedding):
            token_embeddings = [token_embeddings]
        super().__init__(**kwargs)
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        parts = [np.asarray(
            emb.get_vecs_by_tokens(self._idx_to_token).asnumpy())
            for emb in token_embeddings]          # one batched gather each
        self._idx_to_vec = array(np.concatenate(parts, axis=1)
                                 .astype(np.float32))
