"""The LM stack of the port, for the architectures it runs so far
(xLSTM: ``models/xlstm.py``, assembled by ``models/transformer.py``)."""
