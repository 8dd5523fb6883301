"""Register and shared-memory budget of the compiled Hopper kernels (the
counterpart of ``repro/analysis/vmem.py``, which rebuilds a Pallas
launch's VMEM residency from its BlockSpecs).

A CUDA kernel's residency is fixed when ``nvcc`` compiles it, so this
module reads it from the built ``lib<name>.so`` of each source under
``kernels/csrc``, on a machine with the CUDA toolkit:

- ``cuobjdump --dump-resource-usage``: per ``__global__`` function (each
  template instance) its registers per thread (``REG``), static shared
  memory (``SHARED``), local memory (``LOCAL``) and stack frame
  (``STACK``, where ``ptxas`` puts its spills) in bytes. A cached build
  runs no ``nvcc``, so ``-Xptxas -v``'s log is not there to read;
- ``cuobjdump -elf``: the threads per block ``__launch_bounds__`` allows
  (``EIATTR_MAX_THREADS``);
- the source: the minimum of blocks per SM that ``__launch_bounds__``
  promises, where it promises one (``flash_attention_tc.cu``: 2);
- the dynamic shared memory the three launchers that raise
  ``cudaFuncAttributeMaxDynamicSharedMemorySize`` ask for, from each
  source's ``*_smem_bytes`` entry point, at a launch's head dim (and
  input type).

The budget is the H100's (the ``hopper-kernels`` guide's table): at most
232,448 bytes of shared memory per block, 255 registers per thread, and
registers x threads x promised blocks per SM within the SM's 65,536. A
kernel over it gives a ``cuda.resources`` error; spilled bytes give a
warning.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.oplog import Finding, OpContext, rule
from repro_torch.kernels import build

SMEM_PER_BLOCK = 232_448       # H100: shared memory per block, opted in
REGS_PER_THREAD = 255
REGS_PER_SM = 65_536


@dataclass(frozen=True)
class Budget:
    smem_per_block: int = SMEM_PER_BLOCK
    regs_per_thread: int = REGS_PER_THREAD
    regs_per_sm: int = REGS_PER_SM


# sources whose launcher sets dynamic shared memory: source -> (entry
# point, the launch shapes it takes as (label, args) pairs)
DYNAMIC_SMEM = {
    "flash_attention": ("flash_attention_f32_smem_bytes",
                        tuple((f"D={d}", (d,)) for d in (32, 64, 128))),
    "flash_attention_tc": ("flash_attention_bf16_smem_bytes",
                           tuple((f"D={d}", (d,)) for d in (32, 64, 128))),
    "wkv6": ("wkv6_smem_bytes",
             tuple((f"{t} K={k}", (int(t == "bf16"), k))
                   for t in ("f32", "bf16") for k in (32, 64))),
}


@dataclass
class KernelStats:
    """One compiled ``__global__`` function (a template instance)."""
    source: str                 # kernels/csrc/<source>.cu
    symbol: str                 # its mangled symbol
    function: str               # the symbol demangled, where a tool can
    kernel: str                 # the __global__ function's name
    registers: int              # per thread
    static_smem: int            # bytes per block
    local_bytes: int            # local memory per thread
    stack_bytes: int            # stack frame per thread (ptxas's spills)
    max_threads: int            # per block, from __launch_bounds__
    min_blocks: int = 1         # per SM, promised by __launch_bounds__
    dynamic_smem: Dict[str, int] = field(default_factory=dict)

    @property
    def spill_bytes(self) -> int:
        return self.local_bytes + self.stack_bytes

    @property
    def smem_bytes(self) -> int:
        """Static plus the largest dynamic request, per block."""
        return self.static_smem + max(self.dynamic_smem.values(), default=0)

    def to_json(self) -> dict:
        return {"source": f"kernels/csrc/{self.source}.cu",
                "kernel": self.kernel, "function": self.function,
                "registers": self.registers,
                "static_smem": self.static_smem,
                "dynamic_smem": dict(self.dynamic_smem),
                "spill_bytes": self.spill_bytes,
                "max_threads": self.max_threads,
                "min_blocks": self.min_blocks}


# ---------------------------------------------------------------------------
# parsers (pure text: the tests run them on output captured on the card)
# ---------------------------------------------------------------------------

_USAGE_RE = re.compile(
    r"Function (\S+?):\s*\n\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) "
    r"LOCAL:(\d+)")


def parse_resource_usage(text: str) -> Dict[str, Tuple[int, int, int, int]]:
    """``cuobjdump --dump-resource-usage`` -> {symbol: (registers, stack,
    static shared, local)}."""
    return {m.group(1): tuple(int(m.group(i)) for i in range(2, 6))
            for m in _USAGE_RE.finditer(text)}


def parse_max_threads(text: str) -> Dict[str, int]:
    """``cuobjdump -elf`` -> {symbol: threads per block its
    ``EIATTR_MAX_THREADS`` allows (x * y * z)}."""
    out: Dict[str, int] = {}
    current, want = None, False
    for line in text.splitlines():
        line = line.strip()
        if line.startswith(".nv.info."):
            current, want = line[len(".nv.info."):], False
        elif "EIATTR_MAX_THREADS" in line:
            want = current is not None
        elif want and line.startswith("Value:"):
            n = 1
            for v in line.split()[1:]:
                n *= int(v, 16)
            out[current] = n
            want = False
    return out


_GLOBAL_RE = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\(([^()]*)\)\s*)?(\w+)\s*\(")


def launch_bounds(source_text: str) -> Dict[str, int]:
    """{__global__ function: the blocks per SM its ``__launch_bounds__``
    promises (1 where it promises none)} from a ``.cu`` source."""
    out = {}
    for m in _GLOBAL_RE.finditer(source_text):
        args = [a.strip() for a in (m.group(1) or "").split(",")]
        out[m.group(2)] = (int(args[1]) if len(args) == 2
                           and args[1].isdigit() else 1)
    return out


def _kernel_of(symbol: str, kernels: Iterable[str]) -> str:
    """The __global__ function a (mangled) symbol instantiates."""
    for name in sorted(kernels, key=len, reverse=True):
        if f"{len(name)}{name}" in symbol or symbol == name:
            return name
    return symbol


def stats_from_text(source: str, usage: str, elf: str, source_text: str,
                    names: Optional[Dict[str, str]] = None
                    ) -> List[KernelStats]:
    """The KernelStats of one library from its two ``cuobjdump`` dumps
    and its source; ``names`` maps symbols to demangled names."""
    threads = parse_max_threads(elf)
    bounds = launch_bounds(source_text)
    out = []
    for sym, (reg, stack, shared, local) in parse_resource_usage(
            usage).items():
        kern = _kernel_of(sym, bounds)
        out.append(KernelStats(
            source=source, symbol=sym, function=(names or {}).get(sym, sym),
            kernel=kern, registers=reg, static_smem=shared,
            local_bytes=local, stack_bytes=stack,
            max_threads=threads.get(sym, 0),
            min_blocks=bounds.get(kern, 1)))
    return out


def check_stats(stats: Iterable[KernelStats], budget: Budget,
                label: str = "") -> List[Finding]:
    """``cuda.resources`` findings for compiled kernels."""
    findings = []
    for s in stats:
        where = f"{s.source}.cu:{s.function}"
        if s.registers > budget.regs_per_thread:
            findings.append(Finding(
                "cuda.resources", f"{s.registers} registers per thread "
                f"exceed {budget.regs_per_thread}", label=label,
                location=where))
        if s.smem_bytes > budget.smem_per_block:
            findings.append(Finding(
                "cuda.resources",
                f"{s.smem_bytes} bytes of shared memory per block (static "
                f"{s.static_smem} + dynamic {s.smem_bytes - s.static_smem})"
                f" exceed {budget.smem_per_block}", label=label,
                location=where))
        regs = s.registers * s.max_threads * s.min_blocks
        if regs > budget.regs_per_sm:
            findings.append(Finding(
                "cuda.resources",
                f"{s.registers} registers x {s.max_threads} threads x "
                f"{s.min_blocks} blocks per SM = {regs} exceed the SM's "
                f"{budget.regs_per_sm}", label=label, location=where))
        if s.spill_bytes > 0:
            findings.append(Finding(
                "cuda.resources",
                f"{s.spill_bytes} bytes of local memory per thread "
                f"(stack frame {s.stack_bytes}, local {s.local_bytes}): "
                "spilled registers", severity="warning", label=label,
                location=where))
    return findings


# ---------------------------------------------------------------------------
# reading the built libraries (on a machine with the CUDA toolkit)
# ---------------------------------------------------------------------------


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise RuntimeError(f"{name} not found: cuda.resources reads the "
                           "built kernels with the CUDA toolkit")
    return path


def _run(*cmd: str, text_in: Optional[str] = None) -> str:
    return subprocess.run(cmd, input=text_in, capture_output=True,
                          text=True, check=True).stdout


def _demangle(symbols: List[str]) -> Dict[str, str]:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None or not symbols:
        return {}
    lines = _run(tool, text_in="\n".join(symbols) + "\n").splitlines()
    return dict(zip(symbols, lines)) if len(lines) == len(symbols) else {}


def _dynamic(source: str, s: KernelStats) -> Dict[str, int]:
    """The dynamic shared memory each launch shape of ``s``'s template
    instance asks for: its last integer template argument is the head
    dim (flash attention) or K (wkv6), whose first is the input type."""
    if source not in DYNAMIC_SMEM:
        return {}
    symbol, shapes = DYNAMIC_SMEM[source]
    fn = build.kernel(source, symbol)
    ints = re.findall(r"Li(\d+)E", s.symbol)
    bf16 = "I13__nv_bfloat16" in s.symbol
    return {label: int(fn(*args)) for label, args in shapes
            if (not ints or int(ints[-1]) == args[-1])
            and (source != "wkv6" or bf16 == bool(args[0]))}


_cache: Dict[str, List[KernelStats]] = {}


def library_stats(source: str) -> List[KernelStats]:
    """The compiled kernels of ``kernels/csrc/<source>.cu`` (built first
    if needed), with the dynamic shared memory of each launch shape."""
    if source not in _cache:
        build.build_all((source,))
        so = str(build._target(source))
        cuobjdump = _tool("cuobjdump")
        usage = _run(cuobjdump, "--dump-resource-usage", so)
        elf = _run(cuobjdump, "-elf", so)
        src = (build.CSRC / f"{source}.cu").read_text()
        names = _demangle(list(parse_resource_usage(usage)))
        stats = stats_from_text(source, usage, elf, src, names)
        for s in stats:
            s.dynamic_smem = _dynamic(source, s)
        _cache[source] = stats
    return _cache[source]


def all_stats(sources: Iterable[str] = tuple(build.SIGNATURES)
              ) -> List[KernelStats]:
    """Every compiled ``__global__`` function of every kernel source."""
    return [s for src in sources for s in library_stats(src)]


def _sources(entry) -> Tuple[str, ...]:
    """The kernel sources one kernel-scope entry launches: bf16 attention
    has a source of its own."""
    name = entry.name[len("kernel:"):]
    if name == "flash_attention":
        ops_ = entry.arg("operands") or ()
        bf16 = bool(ops_) and str(ops_[0].dtype) == "torch.bfloat16"
        return ("flash_attention_tc" if bf16 else "flash_attention",)
    return (name,)


def _launch_smem(entry, source: str) -> Optional[Tuple[str, int]]:
    """(label, bytes) of the dynamic shared memory this launch asks for."""
    if source not in DYNAMIC_SMEM:
        return None
    symbol, _ = DYNAMIC_SMEM[source]
    first = entry.arg("operands")[0]
    if source == "wkv6":
        args = (int(str(first.dtype) == "torch.bfloat16"), first.shape[-1])
        label = f"{'bf16' if args[0] else 'f32'} K={args[1]}"
    else:
        args = (first.shape[-1],)
        label = f"D={args[0]}"
    return label, int(build.kernel(source, symbol)(*args))


@rule("cuda.resources",
      "every CUDA kernel the step launched fits the H100's registers and "
      "shared memory per block, at the launch shapes the log recorded "
      "(errors; spills are warnings of the library-wide check)")
def _check_resources(ctx: OpContext) -> List[Finding]:
    if ctx.budget is None:
        return []
    findings: List[Finding] = []
    seen = set()
    for e in ctx.log.kernels():
        if e.route != "cuda":
            continue
        for source in _sources(e):
            stats = library_stats(source)
            if source not in seen:
                # errors only: a spill is reported once, over the
                # libraries (repro_torch.analysis.cli.check_libraries)
                seen.add(source)
                findings.extend(f for f in check_stats(stats, ctx.budget,
                                                       ctx.label)
                                if f.severity == "error")
            launch = _launch_smem(e, source)
            if launch is None:
                continue
            label, dyn = launch
            static = max((s.static_smem for s in stats), default=0)
            if dyn < 0 or static + dyn > ctx.budget.smem_per_block:
                findings.append(Finding(
                    "cuda.resources",
                    f"launch at {label} asks for {dyn} bytes of dynamic "
                    f"shared memory (+ {static} static), over the "
                    f"{ctx.budget.smem_per_block} per block",
                    label=ctx.label, location=f"{source}.cu"))
    return findings
