"""The examples of `examples/`, all eleven, in the port.

Each module mirrors `examples/<name>.py`: the same ``build(...)`` arguments
and defaults plus ``device=None`` (the CUDA card; pass ``device="cpu"`` to
run on the CPU), callables written with torch, and a ``main`` that runs
the example's full length and prints its summary.  Run one on the card
with ``python -m climaseaice_jl_tpu_torch.examples.freezing_bucket``.

``diffusive_ice_column_model`` runs the enthalpy column
(:mod:`..enthalpy`), ``ice_ocean_coupled`` the ice over a slab ocean and
``melting_over_dynamic_ocean`` the ice over the shallow-water ocean
(:mod:`..coupled`, :mod:`..ocean`).
"""

NAMES = ("freezing_bucket", "simple_freezing_bucket", "perpetual_night",
         "melting_in_spring", "freezing_of_a_lake", "ice_advected_by_anticyclone",
         "ice_advected_on_coastline", "arctic_basin_seasonal_cycle",
         "diffusive_ice_column_model", "ice_ocean_coupled", "melting_over_dynamic_ocean")
