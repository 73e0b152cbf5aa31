"""Named mixed-precision dtype policies (parity: mxnet_tpu/dtype_policy.py).

* ``f32``        — no casts, no loss scaling.
* ``bf16_mixed`` — bf16 compute / f32 master params + optimizer state,
  with override rules keeping normalization parameters and the loss head
  in f32, and dynamic loss scaling in the train step.
* ``bf16_pure``  — everything bf16 in compute, no f32 islands, no loss
  scaling.

Per-layer overrides are ordered :class:`CastRule` lists: a regex over the
gluon parameter name plus an optional rank filter.  First match wins; no
match means the policy's compute dtype.

Compute follows the *weight*: ``ShardedTrainer`` casts each parameter
per the rules, and FullyConnected / Convolution harmonize their
activation input to the weight's dtype under an installed :func:`scope`,
so a kept-f32 BatchNorm cannot promote the rest of the network back to
f32 and a kept-f32 head computes its logits in f32.

Loss scaling: the step multiplies the loss by the current scale,
unscales the gradients, and an overflowed step keeps the previous
params / optimizer state through the non-finite guard.  The scale state
``[scale, good_steps]`` is a device tensor beside the optimizer state,
updated by :func:`loss_scale_update` with no host sync.

Dtypes are ``torch.dtype``s; the rule regexes are the JAX package's,
letter for letter, so both packages resolve every parameter name alike.
"""
from __future__ import annotations

import contextlib
import re
import threading

import torch

from .base import MXNetError, torch_dtype
from . import config as _config

__all__ = ["note_policy", "CastRule", "DtypePolicy", "LossScaleConfig",
           "register_policy", "get_policy", "list_policies",
           "resolve_policy", "policy_tag", "scope", "current_policy",
           "harmonize", "loss_scale_update", "init_loss_scale"]


class CastRule:
    """One ordered per-layer override: ``pattern`` (regex, ``re.search``
    over the full parameter name) + optional rank filter -> compute dtype
    for that parameter."""

    def __init__(self, name, pattern, dtype, rank=None, min_rank=None):
        self.name = name
        self.pattern = pattern
        self._re = re.compile(pattern)
        self.dtype = torch_dtype(dtype)
        self.rank = rank
        self.min_rank = min_rank

    def matches(self, param_name, shape=None):
        if shape is not None:
            if self.rank is not None and len(shape) != self.rank:
                return False
            if self.min_rank is not None and len(shape) < self.min_rank:
                return False
        return self._re.search(param_name) is not None

    def __repr__(self):
        return "CastRule(%r, %r -> %s)" % (self.name, self.pattern,
                                           self.dtype)


class LossScaleConfig:
    """Dynamic loss-scale schedule: start at ``init``, multiply by
    ``growth`` after ``growth_interval`` consecutive finite steps (capped
    at ``max_scale``), multiply by ``backoff`` on an overflowed step
    (floored at 1.0).  Defaults come from the ``MXNET_LOSS_SCALE*`` env
    knobs at trainer build time."""

    def __init__(self, init=None, growth_interval=None, backoff=None,
                 growth=2.0, max_scale=None):
        self.init = float(init if init is not None
                          else _config.get("MXNET_LOSS_SCALE"))
        self.growth_interval = int(
            growth_interval if growth_interval is not None
            else _config.get("MXNET_LOSS_SCALE_GROWTH_INTERVAL"))
        self.backoff = float(backoff if backoff is not None
                             else _config.get("MXNET_LOSS_SCALE_BACKOFF"))
        self.growth = float(growth)
        self.max_scale = float(max_scale if max_scale is not None
                               else _config.get("MXNET_LOSS_SCALE_MAX"))
        if self.init <= 0 or self.backoff <= 0 or self.backoff >= 1 or \
                self.growth_interval < 1:
            raise MXNetError(
                "invalid loss-scale config: init=%r growth_interval=%r "
                "backoff=%r (want init>0, interval>=1, 0<backoff<1)"
                % (self.init, self.growth_interval, self.backoff))

    def __repr__(self):
        return ("LossScaleConfig(init=%g, growth_interval=%d, "
                "backoff=%g, max=%g)" % (self.init, self.growth_interval,
                                         self.backoff, self.max_scale))


def init_loss_scale(cfg, device=None):
    """Fresh loss-scale state ``[scale, good_steps]`` (f32, on
    ``device``)."""
    return torch.tensor([cfg.init, 0.0], dtype=torch.float32, device=device)


def loss_scale_update(state, keep, cfg):
    """Dynamic loss-scale transition on device tensors (no host sync).

    ``state`` is the ``[scale, good_steps]`` vector, ``keep`` the step's
    all-finite predicate (a bool tensor).  Overflow: scale *= backoff
    (floor 1.0), streak resets.  ``growth_interval`` consecutive finite
    steps: scale *= growth (cap ``max_scale``)."""
    scale, good = state[0], state[1]
    good_next = torch.where(keep, good + 1.0, 0.0)
    grow = good_next >= cfg.growth_interval
    scale_next = torch.where(
        keep,
        torch.where(grow, torch.clamp(scale * cfg.growth,
                                      max=cfg.max_scale), scale),
        torch.clamp(scale * cfg.backoff, min=1.0))
    good_next = torch.where(grow, 0.0, good_next)
    return torch.stack([scale_next, good_next]).to(torch.float32)


class DtypePolicy:
    """A named precision recipe (see module doc).

    Parameters
    ----------
    name : registry name; also the tag trainers report.
    compute_dtype : dtype activations and (rule-permitting) parameters
        are cast to inside the train step.
    param_dtype : the master/storage dtype of parameters and optimizer
        state.
    rules : ordered :class:`CastRule` list; first match wins, no match
        means ``compute_dtype``.
    loss_scaling : arm dynamic loss scaling in ShardedTrainer.
    cast_outputs : cast floating network outputs to this dtype before the
        loss (None = leave them in compute dtype).
    """

    def __init__(self, name, compute_dtype, param_dtype="float32",
                 rules=(), loss_scaling=False, cast_outputs="float32"):
        self.name = name
        self.compute_dtype = torch_dtype(compute_dtype)
        self.param_dtype = torch_dtype(param_dtype)
        self.rules = list(rules)
        self.loss_scaling = bool(loss_scaling)
        self.cast_outputs = (torch_dtype(cast_outputs)
                             if cast_outputs is not None else None)

    @property
    def tag(self):
        return self.name

    def param_cast_dtype(self, param_name, shape=None):
        """Compute dtype for one named parameter: the first matching
        override rule wins, else the policy compute dtype."""
        for r in self.rules:
            if r.matches(param_name, shape):
                return r.dtype
        return self.compute_dtype

    def rule_name(self, param_name, shape=None):
        """Name of the override rule that fires for ``param_name`` (None
        = no override, compute dtype applies)."""
        for r in self.rules:
            if r.matches(param_name, shape):
                return r.name
        return None

    def cast_compute(self, name, tensor):
        """Cast one named tensor toward this policy (no-op for
        non-floating tensors or already-right dtypes)."""
        if not tensor.is_floating_point():
            return tensor
        tgt = self.param_cast_dtype(name, tuple(tensor.shape))
        return tensor if tensor.dtype == tgt else tensor.to(tgt)

    def cast_output(self, tensor):
        if self.cast_outputs is None or not tensor.is_floating_point() \
                or tensor.dtype == self.cast_outputs:
            return tensor
        return tensor.to(self.cast_outputs)

    def describe(self, params=None):
        """Human-readable recipe; with ``params`` (name, shape pairs) also
        the per-parameter resolution."""
        lines = ["policy=%s compute=%s params=%s loss_scaling=%s"
                 % (self.name, self.compute_dtype, self.param_dtype,
                    self.loss_scaling)]
        for r in self.rules:
            lines.append("  rule %-16s %-40s -> %s"
                         % (r.name, r.pattern, r.dtype))
        for n, s in (params or ()):
            lines.append("  %-48s %-10s rule=%s"
                         % (n, self.param_cast_dtype(n, s),
                            self.rule_name(n, s) or "<compute>"))
        return "\n".join(lines)

    def __repr__(self):
        return "DtypePolicy(%r, compute=%s, %d rules)" % (
            self.name, self.compute_dtype, len(self.rules))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY = {}
_REGISTRY_LOCK = threading.Lock()


def register_policy(policy, overwrite=False):
    if not isinstance(policy, DtypePolicy):
        raise MXNetError("register_policy takes a DtypePolicy, got %s"
                         % type(policy).__name__)
    with _REGISTRY_LOCK:
        if policy.name in _REGISTRY and not overwrite:
            raise MXNetError("dtype policy %r is already registered "
                             "(pass overwrite=True)" % policy.name)
        _REGISTRY[policy.name] = policy
    return policy


def get_policy(name):
    with _REGISTRY_LOCK:
        p = _REGISTRY.get(name)
    if p is None:
        raise MXNetError("unknown dtype policy %r (registered: %s)"
                         % (name, sorted(_REGISTRY)))
    return p


def list_policies():
    with _REGISTRY_LOCK:
        return sorted(_REGISTRY)


def resolve_policy(spec=None):
    """``dtype_policy=`` argument -> DtypePolicy or None (f32, no-op).

    Accepted: None (defer to ``MXNET_DTYPE_POLICY``; '' = f32), a
    registered name, or a DtypePolicy object.  ``"f32"``/''/False
    resolve to None.  Unknown names raise."""
    if isinstance(spec, DtypePolicy):
        return None if spec.name == "f32" else spec
    if spec is None:
        spec = _config.get("MXNET_DTYPE_POLICY")
    if spec in (False, "", "f32", "off", "none", None):
        return None
    if not isinstance(spec, str):
        raise MXNetError("dtype_policy must be a DtypePolicy or a "
                         "registered name, got %s" % type(spec).__name__)
    return get_policy(spec)


def policy_tag(policy):
    """Canonical string tag of a policy: its name, ``"f32"`` for the
    no-policy path."""
    if policy is None:
        return "f32"
    return policy.tag if isinstance(policy, DtypePolicy) else str(policy)


# ---------------------------------------------------------------------------
# scope: parameterized ops harmonize compute to the weight
# ---------------------------------------------------------------------------

# a thread-local, not a ContextVar: torch.compile traces a thread-local's
# read (the policy then becomes a guard of the compiled graph), while a
# ContextVar.get breaks the graph
class _ScopeState(threading.local):
    def __init__(self):
        self.policy = None


_scope_state = _ScopeState()


def note_policy(policy, where):
    """Telemetry info gauge for the active policy at a build site."""
    from . import telemetry as _telemetry

    if _telemetry.enabled():
        _telemetry.DTYPE_POLICY_INFO.set(1, policy=policy_tag(policy),
                                         where=where)


@contextlib.contextmanager
def scope(policy):
    """Install ``policy`` for the duration of a forward (no-op for
    None).  FullyConnected/Convolution consult it via :func:`harmonize`."""
    if policy is None:
        yield None
        return
    prev = _scope_state.policy
    _scope_state.policy = policy
    try:
        yield policy
    finally:
        _scope_state.policy = prev


def current_policy():
    return _scope_state.policy


def harmonize(data, weight):
    """Cast ``data`` to ``weight``'s floating dtype under an active policy
    scope (compute follows the weight).  Identity when no policy scope is
    installed."""
    if current_policy() is None:
        return data
    if not weight.is_floating_point() or not data.is_floating_point() \
            or weight.dtype == data.dtype:
        return data
    return data.to(weight.dtype)


# ---------------------------------------------------------------------------
# canonical built-ins
# ---------------------------------------------------------------------------

register_policy(DtypePolicy("f32", "float32", rules=(),
                            loss_scaling=False, cast_outputs=None))

# normalization statistics/affine params and the loss head stay f32.
# gamma/beta/moving/running suffixes are norm params by mxnet convention
# whatever the prefix; weight/bias only count as norm params under a
# norm/ln/bn-ish prefix.
_NORM_F32 = CastRule(
    "norm_f32",
    r"(^|_)(gamma|beta|moving_mean|moving_var|running_mean|"
    r"running_var)$|(norm|ln|bn)[a-z0-9_]*_(weight|bias)$", "float32")
_HEAD_F32 = CastRule("head_f32", r"(head|logits|lm_head)\d*_(weight|bias)$",
                     "float32")

register_policy(DtypePolicy(
    "bf16_mixed", "bfloat16", param_dtype="float32",
    rules=(_NORM_F32, _HEAD_F32), loss_scaling=True,
    cast_outputs="float32"))

register_policy(DtypePolicy(
    "bf16_pure", "bfloat16", param_dtype="float32", rules=(),
    loss_scaling=False, cast_outputs=None))
