"""One module per model family: everything in the benchmark that depends on
a model's architecture.

A configuration file names its family with the key ``"family"`` (``dense``
where it has none); the family is the file ``families/<family>.py``, which
``harness.family`` imports as ``chipbench.families.<family>``. So a family
is added by adding its file, and a configuration of it by adding the
configuration's file. The harness reaches a configuration's
sizes, weights, reference, work counts and model check only through its
family's module, which provides:

- ``sizes(c)``: the family's sizes from the configuration file's numbers
  ``c`` (as run: ``harness.as_run``), with at least ``vocab``, the
  vocabulary the prompts draw their ids from;
- ``arch_config(c)``: the port's ``ArchConfig`` of the file, checked field
  by field against it, so that a change of the port's registry stops the
  benchmark instead of measuring another model (``chipbench.program`` is
  the only module that imports the port);
- ``make_weights(sizes, dtype, seed, device)``: the weights of ``--seed``
  as the port's model takes them, made on the device
  (``weights.tree_of``);
- ``reference(c, weights, fp8=False)``: the plain reference over those
  weights, an object with ``served_logits(prompts, served)`` that returns
  the logits at the positions that chose each served token, in plain fp32
  torch with TF32 off; ``fp8`` is the control (the reference's products in
  float8 e4m3). It imports nothing of the program;
- the work counts the per-layer readers divide by, each
  ``(sizes, batch)`` with ``batch`` a ``work.Batch``:
  ``products_bound_s`` (least seconds of every weight product of a batch),
  ``model_flops`` (the model's operations in a batch),
  ``flash_attention_bound_s`` (least seconds of every layer's prefill
  attention) and ``decode_attention_bound_s`` (least seconds of every
  layer's decode attention). A family whose path never runs the kernel a
  count is for leaves that count out, and its reader reports nothing.
"""
