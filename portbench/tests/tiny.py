"""A tiny stand-in for the training cell's configuration and mix, for
CPU runs."""

MODEL = {"vocab": 256, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
         "n_layers": 2, "d_ff": 256}

TRAIN = {"model": MODEL, "traffic": {"batch": 2, "seq": 64}}
