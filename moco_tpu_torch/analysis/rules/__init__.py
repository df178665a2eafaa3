"""Rule modules — importing this package registers every rule with the
engine. One module per rule id; each is held to JAX's paired known-bad /
known-good fixtures (``tests/fixtures/lint/``) by tests/test_torch_analysis.py."""

from moco_tpu_torch.analysis.rules import (  # noqa: F401
    jx011_thread_hygiene,
    jx012_shared_state,
    jx013_lock_order,
    jx015_metric_schema,
    jx016_http_protocol,
    jx017_fault_sites,
    jx018_exit_codes,
)
