"""Command-line tools of the port: the synthetic train-and-score harness
(``synth_train_eval``), the divergence replay (``nan_replay``) and the host
time of an attention call (``attention_host_cost``, card only)."""
