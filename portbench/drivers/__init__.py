"""One driver per way of driving the port, named by a mix's ``driver``
key and found by ``common.driver``: ``train`` drives its training
step."""
