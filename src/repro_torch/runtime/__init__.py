"""Resumable mining runtime of the port.

Checkpointed mining sessions over `repro_torch.core.flexis.mine`: atomic
snapshots of the full mining state (pattern frontier + host bookkeeping +
in-flight metric state from the card) at level-boundary and root-block
granularity, and deterministic fault injection to test them.  The
reference's ``repro.runtime`` minus the distributed plane.
"""
from . import faults
from .faults import FaultPlan, FaultSpec, InjectedCrash, InjectedFault
from .session import MiningSession, PreemptedError
from .state import (
    GroupDone,
    LevelCursor,
    SampledCursor,
    SessionState,
    decode_session,
    encode_session,
)
from .resume import (
    SessionMismatch,
    latest_snapshot,
    load_session,
    session_fingerprint,
)

__all__ = [
    "MiningSession", "PreemptedError",
    "faults", "FaultPlan", "FaultSpec", "InjectedCrash", "InjectedFault",
    "SessionState", "LevelCursor", "GroupDone", "SampledCursor",
    "encode_session", "decode_session",
    "load_session", "latest_snapshot", "session_fingerprint",
    "SessionMismatch",
]
