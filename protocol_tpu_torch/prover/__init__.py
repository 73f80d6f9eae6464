"""Proof jobs: the flat payload one epoch proof needs and its
statement-bound blinding seed (``jobs``).  The asynchronous proving
plane (``plane``, ``workers``) is not ported yet."""

from .jobs import ProofJob, ProofResult, job_fingerprint, job_seed  # noqa: F401
