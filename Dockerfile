# CPU image: tests + validation on the virtual device mesh.
# For a GPU, start from a CUDA image and install jax with its CUDA plugin.
FROM python:3.11-slim AS base

WORKDIR /app
COPY pyproject.toml README.md ./
COPY mixed_precision_multigrid_solvers_for_pdes_tpu ./mixed_precision_multigrid_solvers_for_pdes_tpu
COPY tests ./tests
COPY scripts ./scripts
COPY bench.py chip_smoke.py __graft_entry__.py ./

RUN pip install --no-cache-dir -e .[dev]

# default: run the test suite on the 8-device virtual mesh
CMD ["python", "-m", "pytest", "tests/", "-q"]
