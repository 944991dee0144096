# The dry run's cost model, the reference's ``roofline/`` for the H100:
#   kernel_cost.py -- each hand-written kernel's (flops, bytes), shared by
#                     the dry run and chip_smoke.py's bounds;
#   op_cost.py     -- flops, bytes and kernel calls of a step traced on the
#                     meta device (a TorchDispatchMode over aten ops);
#   analysis.py    -- the card's constants, the roofline terms, parameter
#                     counts and model flops.
