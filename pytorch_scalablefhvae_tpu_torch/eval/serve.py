"""Persistent encode serving: JSONL requests in, JSONL responses out.

Counterpart of ``eval/serve.py``, with the same protocol. ``serve EXP_DIR``
loads the experiment once (weights on the device, MVN stats) and answers
encode requests line by line on stdin:

    request:  {"id": "r1", "inputs": ["a.wav", "dir/", "wav.scp"],
               "output_dir": "out/r1"}          # output_dir optional
    response: {"id": "r1", "ok": true, "utterances": N, "segments": M,
               "sequences": [...], "mu2_map": [[...]...],
               "z1_seq_mean": [[...]...], "output_dir": "out/r1",
               "seconds": {"features": .., "latents": .., "summaries": ..},
               "features_seconds": {"audio": .., "features": ..,
                                    "segments": ..}}

Per-utterance summaries return inline; per-segment latents go to
``output_dir`` (``latents.npz`` + ``sequences.json``) when requested.
``seconds`` is this port's addition to the response: the wall time of the
request's stages (features, then batches + model + copies, then the
summaries). ``features_seconds`` splits the first: the audio read (always on
the host), the extractor (the host's, or with ``extractor: "jax"`` the
batched chain on the device), and MVN + segmenting.

Control: {"cmd": "ping"} -> {"ok": true, "model_type": ..., ...};
{"cmd": "shutdown"} (or EOF) ends the loop. A malformed or failing request
answers {"ok": false, "error": ...} and the server keeps serving.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from pytorch_scalablefhvae_tpu_torch.eval.encode import EncodeSession


def _response_for(session: EncodeSession, req: dict) -> dict:
    rid = req.get("id")
    if req.get("cmd") == "ping":
        return {
            "id": rid, "ok": True,
            "model_type": session.model.model_type,
            "exp_dir": str(session.exp_dir),
            "batch_size": session.batch_size,
            "device": str(session.device),
        }
    inputs = req.get("inputs")
    if not inputs or not isinstance(inputs, list):
        raise ValueError('request needs "inputs": [audio file | dir | scp]')
    out_dir = req.get("output_dir")
    result = session.encode(inputs, output_dir=out_dir,
                            sample_rate=req.get("sample_rate"), verbose=False)
    return {
        "id": rid, "ok": True,
        "utterances": len(result["sequences"]),
        "segments": int(len(result["seq_idx"])),
        "sequences": result["sequences"],
        "mu2_map": result["mu2_map"].tolist(),
        "z1_seq_mean": result["z1_seq_mean"].tolist(),
        "output_dir": str(Path(out_dir)) if out_dir else None,
        "seconds": result["seconds"],
        "features_seconds": result["features_seconds"],
    }


def serve(exp_dir, step: int = -1, batch_size: int = 2048,
          device: str = "cuda", stdin=None, stdout=None) -> int:
    """Run the JSONL serving loop until EOF or a shutdown command.

    ``stdin``/``stdout`` default to the process streams. Returns the
    process exit code.
    """
    fin = stdin if stdin is not None else sys.stdin
    fout = stdout if stdout is not None else sys.stdout
    session = EncodeSession(exp_dir, step=step, batch_size=batch_size,
                            device=device)

    def emit(obj: dict) -> None:
        fout.write(json.dumps(obj) + "\n")
        fout.flush()

    emit({"ok": True, "ready": True, "model_type": session.model.model_type,
          "exp_dir": str(session.exp_dir)})
    for line in fin:
        line = line.strip()
        if not line:
            continue
        rid = None
        try:
            req = json.loads(line)
            rid = req.get("id")
            if req.get("cmd") == "shutdown":
                emit({"id": rid, "ok": True, "bye": True})
                break
            emit(_response_for(session, req))
        except Exception as e:  # serving must survive any one bad request
            emit({"id": rid, "ok": False,
                  "error": f"{type(e).__name__}: {e}"})
    return 0
