# The paper's primary contribution: CPU-NPU collaborative vector-embedding
# serving (WindVE), as the port's own copy of the framework-free reference
# modules.  Queue manager (Alg. 1), device detector (Alg. 2),
# linear-regression queue-depth estimator (Eq. 12), cost model (Eqs. 1-6),
# affinity planner (§4.4), seeded fault injection, the failure-aware
# capacity planner, the calibrated discrete-event simulator and the real
# threaded serving engine with its PyTorch embedder backends (windve,
# bucketing, sharded_backend).
from repro_torch.core import (affinity, cost_model, device_detector,
                              estimator, faults, planner, routing, simulator,
                              telemetry, windve)

__all__ = ["affinity", "cost_model", "device_detector", "estimator",
           "faults", "planner", "routing", "simulator", "telemetry",
           "windve"]
