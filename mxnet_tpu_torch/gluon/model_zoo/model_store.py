"""Model weight store (parity: mxnet_tpu/gluon/model_zoo/model_store.py;
reference gluon/model_zoo/model_store.py).

A locally placed ``{root}/{name}.params`` wins (checked against its
SHA-1 where one is registered); else, when ``MXNET_GLUON_REPO`` names a
base URL, ``{repo}/{name}.params`` is fetched there through
``gluon.utils.download``, which checks the SHA-1 before an atomic write.
``file://`` mirrors serve machines with no network.  No SHA-1 is
registered by default: ``_model_sha1`` is filled by whoever publishes a
mirror.
"""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["get_model_file", "purge", "short_hash"]

_model_sha1 = {}


def short_hash(name):
    if name not in _model_sha1:
        raise ValueError("Pretrained model for {name} is not available."
                         .format(name=name))
    return _model_sha1[name][:8]


def _repo_url():
    from ... import config as _config

    return _config.get("MXNET_GLUON_REPO")


def get_model_file(name, root=os.path.join("~", ".mxnet", "models")):
    """The path of ``name``'s ``.params`` file under ``root``, fetched from
    the ``MXNET_GLUON_REPO`` mirror if it is not there."""
    from ..utils import check_sha1, download

    root = os.path.expanduser(root or os.path.join("~", ".mxnet", "models"))
    fname = os.path.join(root, "%s.params" % name)
    sha1 = _model_sha1.get(name)
    if os.path.exists(fname) and (sha1 is None or check_sha1(fname, sha1)):
        return fname
    repo = _repo_url()
    if repo:
        url = "%s/%s.params" % (repo.rstrip("/"), name)
        return download(url, path=fname, overwrite=True, sha1_hash=sha1)
    raise MXNetError(
        "Pretrained weights for %s not found under %s and no download "
        "mirror is configured: place the .params file there or set "
        "MXNET_GLUON_REPO (file:// mirrors work offline)." % (name, root))


def purge(root=os.path.join("~", ".mxnet", "models")):
    """Delete every ``.params`` file under ``root``."""
    root = os.path.expanduser(root)
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))
