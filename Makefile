# Convenience targets (the reference Makefile cloned and built all of Kaldi
# to obtain compute-fbank-feats; here `make native` builds the in-tree C++
# equivalents in one compiler invocation).

.PHONY: native native-asan test test-all bench quality clean

native:
	python -c "from pytorch_scalablefhvae_tpu.native.binding import build_native; print(build_native(rebuild=True))"

native-asan:
	python -c "from pytorch_scalablefhvae_tpu.native.binding import build_native; print(build_native(rebuild=True, sanitize=True))"

# fast gate: skips the `slow`-marked compile-heavy tiers (<5 min on a
# 1-core CPU box); `test-all` is the full pyramid
test:
	python -m pytest tests/ -q -m "not slow"

test-all:
	python -m pytest tests/ -q

bench:
	python bench.py

# reproduce the measured-training-quality claim (PARITY.md); compare the
# resulting metrics.jsonl against misc/repro_quality_metrics.jsonl
quality:
	bash misc/repro_quality.sh

clean:
	rm -f pytorch_scalablefhvae_tpu/native/*.so pytorch_scalablefhvae_tpu_torch/native/*.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
