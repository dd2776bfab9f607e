"""EAAS core: experts disaggregated into stateless services.

  router          gating + top-k (+ aux losses)              (§2.1)
  mapping         expert->server service discovery table     (Fig. 6)
  dispatch        buffer-slot packing / combine              (§3.2)
  comm            client-initiated transfers (local mode)    (§4.4)
  expert_server   stateless dynamic-batch server             (§3.3, Fig. 5)
  moe_layer       the EaasMoELayer                           (Fig. 4)
  load_balance    EPLB-style replication planner             (§4.5)
  elastic         the server pool: liveness + replication    (§5.3)
  monolithic      the baselines: monolithic EP, TP (S = 1)    (§2.2, §5)
  overlap         two-microbatch (double-batch) decode        (§4.2)
"""
