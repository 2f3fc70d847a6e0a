"""GDPR unlearning compliance of the port: retained-equivalence proofs.

The certificate behind ``StreamingEngine.forget_user`` receipts (DESIGN.md
§11): given an engine and the event log it processed, prove that the
maintained state is equivalent to a model fit on the retained data only
-- bitwise for pure-add histories, within the derived §4.3
path-dependence envelope for deletion-bearing histories -- and that
forgotten users left no trace in any live or persisted artifact.
"""
from repro_torch.compliance.certify import (DEFAULT_PATH_ATOL, CheckResult,
                                            ComplianceReport,
                                            basket_weights, certify,
                                            divergence_envelope,
                                            retained_histories)

__all__ = ["DEFAULT_PATH_ATOL", "CheckResult", "ComplianceReport",
           "basket_weights", "certify", "divergence_envelope",
           "retained_histories"]
