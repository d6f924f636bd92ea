"""Training: the optimizers (:mod:`repro_torch.train.optim`) and the
fault-tolerant loop (:mod:`repro_torch.train.trainer`)."""
