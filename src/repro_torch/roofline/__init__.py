"""The dry run's census and roofline on the H100 (the JAX package's
``repro/roofline``): ``census`` counts what a step dispatches on the meta
device, ``analysis`` turns it into the three-term roofline."""
