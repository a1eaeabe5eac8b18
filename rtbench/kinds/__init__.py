"""Kinds of call, each a module that a traffic mix names by its ``call``.

A kind's module gives:

- ``setup(mix)``: what its calls share, built after the model build into
  ``mix.shared`` (such as a Jacobian's function), which ``Mix.release``
  drops before the reference runs;
- ``state(mix, i)``, optional: call i's state, where the kind draws its
  own in place of ``Mix.state``'s retrieval state;
- ``call(mix, state)``: one call on the program, returning its outputs at
  the sampled points ``mix.sample`` as host arrays;
- ``reference(mix, state, products)``: the same outputs from the plain
  reference (``rtbench.reference``), with the products and solves
  ``products`` (exact, or bfloat16 for the control);
- ``work(mix, state)``: the call's layer steps as (n, points, doublings),
  counted by the reference's doubling rule, for the roofline (empty where
  the roofline does not apply).

Outputs are ``R`` and ``T`` (n_vza, n_stokes, points), and for a Jacobian
``K`` (..., columns), each column named in the module's ``COLUMNS``.
"""
