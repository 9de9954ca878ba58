"""repro_torch.examples — the JAX package's examples on the port.

  quickstart          a 3-step federated workflow whose middle step is a
                      model forward, cold then warm then rerouted
  document_workflow   the paper's §4.2 document workflow on the real engine
                      (DAG with and without pre-fetching, the chain, the
                      automated placement), then priced by the simulator
  federated_serving   prefill -> decode as a GeoFF workflow, then continuous
                      batching
  train_lm            a reduced LM trained with the checkpoint/restart drill

Each runs as ``python -m repro_torch.examples.<name>`` with the
reference's flags plus ``--device``: on the card by default, and it raises
without CUDA unless given ``--device cpu``.
"""
