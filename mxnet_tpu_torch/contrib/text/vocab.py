"""Text vocabulary (parity: mxnet_tpu/contrib/text/vocab.py;
python/mxnet/contrib/text/vocab.py): counter-driven construction,
unknown and reserved tokens, index round trips, one ordered token table
built in a single pass.
"""
from __future__ import annotations

__all__ = ["Vocabulary"]


class Vocabulary:
    """Token <-> index maps from a frequency counter.

    Index 0 is the unknown token; reserved tokens follow; the remaining
    tokens are ordered by descending frequency (ties broken
    alphabetically, matching the reference) and filtered by
    ``most_freq_count`` / ``min_freq``.
    """

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be at least 1")
        reserved = list(reserved_tokens or [])
        if unknown_token in reserved or len(set(reserved)) != len(reserved):
            raise ValueError("reserved tokens must be unique and must not "
                             "contain the unknown token")
        self._unknown_token = unknown_token
        self._reserved_tokens = reserved or None
        self._idx_to_token = [unknown_token] + reserved
        if counter is not None:
            ranked = sorted(counter.items(),
                            key=lambda kv: (-kv[1], kv[0]))
            skip = set(self._idx_to_token)
            taken = 0
            for token, freq in ranked:
                if freq < min_freq or (most_freq_count is not None
                                       and taken >= most_freq_count):
                    break
                if token not in skip:
                    self._idx_to_token.append(token)
                    taken += 1
        self._token_to_idx = {t: i for i, t in
                              enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) -> index(es); unknown tokens map to index 0."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        """Index(es) -> token(s)."""
        single = not isinstance(indices, (list, tuple))
        idxs = [indices] if single else indices
        out = []
        for i in idxs:
            if not 0 <= int(i) < len(self._idx_to_token):
                raise ValueError("index %r out of vocabulary range" % (i,))
            out.append(self._idx_to_token[int(i)])
        return out[0] if single else out
