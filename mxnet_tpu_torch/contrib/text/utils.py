"""Text utilities (parity: mxnet_tpu/contrib/text/utils.py)."""
from __future__ import annotations

import re
from collections import Counter

__all__ = ["count_tokens_from_str"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Token frequency Counter from delimited text."""
    source_str = re.sub(re.escape(token_delim), " ",
                        re.sub(re.escape(seq_delim), " ", source_str))
    if to_lower:
        source_str = source_str.lower()
    counter = counter_to_update if counter_to_update is not None \
        else Counter()
    counter.update(t for t in source_str.split(" ") if t)
    return counter
