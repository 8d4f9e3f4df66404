"""Training regimes, one module each, found by the ``regime`` that a
configuration names (:func:`perfbench.parts.find`). A regime's module
builds the program's trainer for it and names its reference:

* ``inputs(maker, cfg, data)``: the regime's own inputs beside the cohort;
* ``build(cfg, data, model, seed, device, dtype)``: the trainer of
  ``model``;
* ``trained(trainer)``: every tensor a step trains, by the names of the
  state :class:`perfbench.inputs.Maker` makes (``vae.*`` and ``gp.*``
  leaves and the regime's own tensors);
* ``WARM_EPOCHS`` and ``COMPARED_EPOCHS``: the epochs that capture the step
  and warm it, and the epochs that hold the three compared steps; the
  reference skips the first's draws (``skip_epochs``);
* ``steps_of(trainer, epochs)``: the last chunk's per-step metrics;
* ``steps_per_epoch(trainer)``;
* ``reference``: the reference's steps (:mod:`perfbench.reference.steps`);
* ``step_flops(cfg)``: a step's operations (:mod:`perfbench.counts`);
* ``half_batch(replay_only)``: a context that plants the fault of half of
  each batch left out, the mean over the rest, in the program; with
  ``replay_only`` only in what a CUDA graph captures."""
