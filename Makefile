# Convenience targets (the reference drives tests/benchmarks with
# Makefiles too: mogp_emulator/tests/Makefile, benchmarks/Makefile).

PY ?= python

.PHONY: test bench benchmarks demos

test:
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

# the full benchmark suite (CPU-safe; scaling numbers are meaningful on GPUs)
benchmarks:
	cd benchmarks && $(PY) benchmark_branin.py
	cd benchmarks && $(PY) benchmark_rosenbrock.py
	cd benchmarks && $(PY) benchmark_MICE.py
	cd benchmarks && $(PY) benchmark_pivot.py
	cd benchmarks && $(PY) benchmark_historymatching.py
	cd benchmarks && $(PY) benchmark_kdr_GP.py
	cd benchmarks && $(PY) benchmark_scaling.py
	cd benchmarks && $(PY) benchmark_nuts.py
	cd benchmarks && $(PY) benchmark_tsunami.py

demos:
	cd demos && $(PY) tutorial.py
	cd demos && $(PY) multioutput_tutorial.py
	cd demos && $(PY) gp_kernel_demos.py
	cd demos && $(PY) historymatch_demos.py
	cd demos && $(PY) mice_demos.py
	cd demos && $(PY) kdr_demos.py
	cd demos && $(PY) inference_demos.py
	cd demos && $(PY) excalibur_workshop_demo.py
