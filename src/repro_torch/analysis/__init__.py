"""repro_torch.analysis: the port's static checker for its kernels and code.

Port of ``repro/analysis`` (whose rules check Pallas BlockSpecs and jaxprs),
rewritten for hand-written CUDA kernels and PyTorch code. Two layers:

* Layer 1, contracts (``contracts`` + ``registry``): every lowering of
  ``kernels.IMPLS`` / ``ATTN_IMPLS``, the LIF kernel and the decode
  attention kernel have an entry mirroring its launch (grid, tile, tail
  guards), counters and shared-memory model; the checks run over a shape
  matrix with a non-divisible extent in every dimension. On the CPU they read
  the Python plans and models; on the card (``--layer contracts`` with the
  library built) also the library's exports and ptxas's registers, shared
  memory and spills.
* Layer 2, lint (``lint``): AST rules over ``src/repro_torch/**``.

| Rule | Defect class |
| --- | --- |
| ``PHI-COV-GRID`` | A launch plan whose blocks do not reach an output dim, or overshoot it with no tail guard in the kernel's source; a plain lowering whose output lacks the logical shape; a Python plan that differs from the library's export. |
| ``PHI-ACC-WIDTH`` | A per-block exact counter (``l2_nnz``, int32) whose registry bound passes its dtype's exact-integer range. |
| ``PHI-SMEM-MODEL`` | A shared-memory model (``phi_fused.fused_smem_bytes``, ``stream_smem_bytes``, ``phi_attention.smem_bytes`` behind ``ops._attn_smem_bytes``, ``matcher.matcher_plan``, ``decode_attention.plan``) past 227 KB where the gate admits the shape, or below the library's export; a kernel ptxas says spills. |
| ``PHI-LINT-IMPORT`` | An import of ``jax`` or of the reference package ``repro``. |
| ``PHI-LINT-FALLBACK`` | A ``try`` around a ``*_cuda`` call or the library build/load whose handler carries on instead of raising. |
| ``PHI-LINT-HWCONST`` | A hardware constant hard-coded outside ``core/hwconst.py``. |
| ``PHI-LINT-PLACEMENT-DUP`` | A placement tuple naming one mesh axis twice. |
| ``PHI-LINT-HOSTSYNC`` | ``.item()``, ``.tolist()``, ``bool()`` or an ``if``/``while`` on a tensor in a kernel wrapper or a per-rank body. |

Run ``PYTHONPATH=src python -m repro_torch.analysis [--layer all|lint|contracts]
[--json out.json]``: exit 0 clean, 1 a live finding, 2 an invalid baseline
entry (no justification) or a stale one (its rule ran and nothing matched
it). ``baseline.json`` is the only suppression, each entry with a written
justification.
"""
from repro_torch.analysis.contracts import ContractFinding, Cover  # noqa: F401
from repro_torch.analysis.lint import Finding, lint_paths, lint_source  # noqa: F401
