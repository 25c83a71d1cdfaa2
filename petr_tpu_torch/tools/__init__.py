"""Command-line tools of the port: the synthetic train-and-score harness
(``synth_train_eval``) and the divergence replay (``nan_replay``)."""
