"""Model layer: the EigenTrust model, graph and churn generators."""

from .churn import churn_cohort_dims, sender_centric_churn  # noqa: F401
from .eigentrust import EigenTrustModel  # noqa: F401
from .graphs import erdos_renyi, scale_free, sybil_stress  # noqa: F401
