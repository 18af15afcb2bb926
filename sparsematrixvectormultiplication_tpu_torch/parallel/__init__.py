"""Multi-device SpMV and SpMM over ``torch.distributed``: the port of the JAX
package's ``parallel/``. Ranks and process groups (``launch``), the nnz
balance (``scheduler``), the ELL paths and the device mesh (``sharding``),
SELL shards on several devices from one process (``multidevice``), and one
shard per rank for SELL SpMV and SpMM (``spmd_pallas``), BSR SpMM
(``spmd_bsr``), PR (``spmd_pr``), the locality split (``spmd_split``) and
column-sharded SELL (``spmd_colsell``)."""
