"""The plain reference of the RNN-T that the benchmark holds the port to.

Plain PyTorch in float32 (TF32 off), written from the published model: the
log-mel front end, the LSTM encoder and predictor, the joint, the
transducer loss, LAMB, and greedy streaming decisions. It imports neither
JAX nor anything of the port, and it takes nothing the port has made: the
benchmark draws the weights and the inputs (``weights.py``) and hands the
same to both sides.

Every product goes through a ``Precision`` (``precision.py``): float32 for
the reference, or float8 (e4m3) for the control, the reference put in the
program's place one precision below the configuration's bfloat16.
"""
