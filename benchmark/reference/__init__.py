"""The benchmark's yardstick, independent of the package under test.

* :mod:`.matrix`: the COO container the generators return, and the hash
  that gives symmetric values;
* :mod:`.fem_3d_spd`: the generator that configurations name, a frozen
  copy of the package's ``models/synthetic.py`` ``fem_3d``;
* :mod:`.products`: the plain fp64 products, row bounds and residuals that
  decide ``correct``;
* :mod:`.roofline`: the bytes and operations a product needs, and the
  least time the card could take for them (``peaks.json``).

Nothing here imports the package under test, JAX or the JAX package.
"""
