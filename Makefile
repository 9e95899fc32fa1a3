# Task runner (analogue of the reference's pixi.toml tasks).

.PHONY: test test-gpu chip-smoke validate repro figures bench flagship lint test-reference

test:
	python -m pytest tests/ -q

test-gpu:
	JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

chip-smoke:
	python chip_smoke.py

validate:
	python experiments/validate_implementation.py

repro:
	python experiments/reproduce_magron2022.py

figures:
	python experiments/display_results.py

bench:
	python bench.py

flagship:
	python experiments/flagship_scale.py --ceiling --sparse

lint:
	python -m compileall -q nbmf_mm_jax experiments tests bench.py chip_smoke.py __graft_entry__.py

test-reference:
	python tools/run_reference_suite.py
