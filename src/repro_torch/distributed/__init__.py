"""repro_torch.distributed — the sharded, replicated and elastic tiers on one
device (the port of the JAX package's ``repro.distributed``).

``kvshard``    — sharded DPA-Store facade + hash/range routed GET waves;
``rangeshard`` — range-partition boundary routing + scatter-gather RANGE;
``rebalance``  — online range-tier rebalancing: two-phase ownership table,
                 reservoir key sampling, boundary-refit planner;
``snapshot``   — epoch-consistent, shard-count-independent store snapshots;
``elastic`` / ``straggler`` — re-mesh and replica-recovery planning, the
                 straggler watchdog.
"""
