# WindVE's scheduling core (queue manager, estimator, simulator, telemetry,
# cache, admission, health) as the port's own copy of the framework-free
# reference modules, plus the serving engine and the PyTorch embedder
# backends (windve, bucketing, sharded_backend).
