"""The benchmark of tvts_torch on one NVIDIA H100: a harness driven by the
data under this folder (see README.md). Nothing here imports JAX or the JAX
package, and the plain reference under reference/ imports nothing of the
program."""
