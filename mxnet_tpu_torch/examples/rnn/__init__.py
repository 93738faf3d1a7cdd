"""``examples/rnn``'s LSTM bucketing language model:
``python -m mxnet_tpu_torch.examples.rnn.lstm_bucketing [--ctx cpu]``."""
