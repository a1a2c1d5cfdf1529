"""Runnable demos of the port: `python -m lws_torch.examples.<name> --help`.

run_lws (the 3-stage pipeline with per-stage timing, wav in and out),
streaming_serve (StreamingLWS's three serving operating points),
streaming_vocoder (mel frames in, committed audio out) and multichip
(data-parallel run_lws and time-sharded batch_lws over spawned or torchrun
ranks). Each runs on CUDA unless given --device cpu.
"""
