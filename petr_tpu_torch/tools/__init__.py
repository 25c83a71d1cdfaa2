"""Command-line tools of the port: the synthetic train-and-score harness
(``synth_train_eval``), the divergence replay (``nan_replay``), the host
time of an attention call (``attention_host_cost``) and where K4's warps
spend their clocks (``k4_clock_split``); the last two card only."""
