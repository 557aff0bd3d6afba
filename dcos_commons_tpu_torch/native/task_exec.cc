// task_exec: native per-task supervisor.
//
// The reference prepends a statically-linked Go binary to every task
// command (sdk/bootstrap/main.go, 513 LoC) so task-side lifecycle is
// owned by native code, not the scheduler's runtime.  This is the
// rebuild's equivalent for the *agent* side: one supervisor process
// per task that
//
//   * starts the task in its own session (process group) with
//     stdout/stderr appended to sandbox files,
//   * persists its own pid (task.pid) and, on child exit, the exit
//     status (exit_status) inside the sandbox — so an agent daemon
//     that crashed and restarted can reconstruct every task's fate
//     from the filesystem instead of losing it with its Python heap,
//   * forwards SIGTERM to the whole task group and escalates to
//     SIGKILL after the configured kill-grace period (the Mesos
//     agent's task-kill semantics).
//
// Usage:
//   task_exec --sandbox DIR [--record-dir RD] [--grace SECONDS] \
//             [--rlimit NAME=SOFT:HARD]... -- <shell command...>
//
// --rlimit applies a setrlimit(2) in the child between fork and exec
// (reference: specification/RLimitSpec.java -> Mesos RLimitInfo on
// the ContainerInfo); -1 means RLIM_INFINITY.  A limit that cannot
// be applied fails the task before its command runs — running
// without the isolation the spec demanded would defeat the point.
//
// Records (task.pid/child.pid/exit_status) go to --record-dir, which
// the agent keys by task INCARNATION — two incarnations of one task
// name share the sandbox (volumes, logs) but never their lifecycle
// records, so a dying predecessor cannot poison its successor's fate.
// Exit code: the child's exit code (128+signal when signalled).

#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/resource.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <time.h>
#include <unistd.h>

#include <string>
#include <vector>

namespace {

volatile sig_atomic_t g_term_requested = 0;

void on_term(int) { g_term_requested = 1; }

void write_file(const std::string& path, const std::string& content) {
  std::string tmp = path + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return;
  ssize_t off = 0;
  while (off < static_cast<ssize_t>(content.size())) {
    ssize_t n = write(fd, content.data() + off, content.size() - off);
    if (n <= 0) break;
    off += n;
  }
  fsync(fd);
  close(fd);
  rename(tmp.c_str(), path.c_str());
}

int open_log(const std::string& sandbox, const char* name) {
  std::string path = sandbox + "/" + name;
  return open(path.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
}

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec / 1e9;
}

struct RLimitArg {
  int resource;
  rlim_t soft;
  rlim_t hard;
};

int rlimit_by_name(const char* name) {
  struct Entry { const char* name; int resource; };
  static const Entry kTable[] = {
      {"RLIMIT_AS", RLIMIT_AS},           {"RLIMIT_CORE", RLIMIT_CORE},
      {"RLIMIT_CPU", RLIMIT_CPU},         {"RLIMIT_DATA", RLIMIT_DATA},
      {"RLIMIT_FSIZE", RLIMIT_FSIZE},     {"RLIMIT_MEMLOCK", RLIMIT_MEMLOCK},
      {"RLIMIT_NOFILE", RLIMIT_NOFILE},   {"RLIMIT_NPROC", RLIMIT_NPROC},
      {"RLIMIT_RSS", RLIMIT_RSS},         {"RLIMIT_STACK", RLIMIT_STACK},
#ifdef RLIMIT_MSGQUEUE
      {"RLIMIT_MSGQUEUE", RLIMIT_MSGQUEUE},
#endif
#ifdef RLIMIT_NICE
      {"RLIMIT_NICE", RLIMIT_NICE},
#endif
#ifdef RLIMIT_RTPRIO
      {"RLIMIT_RTPRIO", RLIMIT_RTPRIO},
#endif
#ifdef RLIMIT_RTTIME
      {"RLIMIT_RTTIME", RLIMIT_RTTIME},
#endif
#ifdef RLIMIT_SIGPENDING
      {"RLIMIT_SIGPENDING", RLIMIT_SIGPENDING},
#endif
  };
  for (const Entry& e : kTable) {
    if (strcmp(name, e.name) == 0) return e.resource;
  }
  return -1;
}

// "NAME=SOFT:HARD" (-1 = infinity) -> RLimitArg; false on parse error
bool parse_rlimit(const char* arg, RLimitArg* out) {
  const char* eq = strchr(arg, '=');
  const char* colon = eq ? strchr(eq, ':') : nullptr;
  if (!eq || !colon) return false;
  std::string name(arg, eq - arg);
  out->resource = rlimit_by_name(name.c_str());
  if (out->resource < 0) return false;
  long long soft = atoll(eq + 1);
  long long hard = atoll(colon + 1);
  out->soft = soft < 0 ? RLIM_INFINITY : static_cast<rlim_t>(soft);
  out->hard = hard < 0 ? RLIM_INFINITY : static_cast<rlim_t>(hard);
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  std::string sandbox;
  std::string record_dir;
  double grace_s = 5.0;
  int cmd_start = -1;
  std::vector<RLimitArg> rlimits;
  for (int i = 1; i < argc; ++i) {
    if (strcmp(argv[i], "--sandbox") == 0 && i + 1 < argc) {
      sandbox = argv[++i];
    } else if (strcmp(argv[i], "--record-dir") == 0 && i + 1 < argc) {
      record_dir = argv[++i];
    } else if (strcmp(argv[i], "--grace") == 0 && i + 1 < argc) {
      grace_s = atof(argv[++i]);
    } else if (strcmp(argv[i], "--rlimit") == 0 && i + 1 < argc) {
      RLimitArg rl;
      if (!parse_rlimit(argv[i + 1], &rl)) {
        fprintf(stderr, "task_exec: bad --rlimit %s\n", argv[i + 1]);
        return 64;
      }
      rlimits.push_back(rl);
      ++i;
    } else if (strcmp(argv[i], "--") == 0) {
      cmd_start = i + 1;
      break;
    } else {
      fprintf(stderr, "task_exec: unknown arg %s\n", argv[i]);
      return 64;
    }
  }
  if (sandbox.empty() || cmd_start < 0 || cmd_start >= argc) {
    fprintf(stderr,
            "usage: task_exec --sandbox DIR [--grace S] -- command...\n");
    return 64;
  }
  mkdir(sandbox.c_str(), 0755);
  if (record_dir.empty()) record_dir = sandbox;
  mkdir(record_dir.c_str(), 0755);  // parent pre-created by the agent

  // join the command words back into one shell string
  std::string command;
  for (int i = cmd_start; i < argc; ++i) {
    if (!command.empty()) command += " ";
    command += argv[i];
  }

  write_file(record_dir + "/task.pid", std::to_string(getpid()) + "\n");

  struct sigaction sa;
  memset(&sa, 0, sizeof(sa));
  sa.sa_handler = on_term;
  sigaction(SIGTERM, &sa, nullptr);
  sigaction(SIGINT, &sa, nullptr);

  pid_t child = fork();
  if (child < 0) {
    perror("task_exec: fork");
    return 70;
  }
  if (child == 0) {
    // task side: own session so the whole tree is one kill target
    setsid();
    int out = open_log(sandbox, "stdout");
    int err = open_log(sandbox, "stderr");
    if (out >= 0) dup2(out, STDOUT_FILENO);
    if (err >= 0) dup2(err, STDERR_FILENO);
    if (chdir(sandbox.c_str()) != 0) _exit(71);
    for (const RLimitArg& rl : rlimits) {
      struct rlimit lim = {rl.soft, rl.hard};
      if (setrlimit(rl.resource, &lim) != 0) {
        perror("task_exec: setrlimit");
        _exit(72);
      }
    }
    execl("/bin/sh", "sh", "-c", command.c_str(), (char*)nullptr);
    perror("task_exec: exec");
    _exit(127);
  }

  // the task's session leader pid: lets the agent force-kill the task
  // group directly if this supervisor is ever lost
  write_file(record_dir + "/child.pid", std::to_string(child) + "\n");

  // supervisor side: wait, forwarding kill requests with grace
  bool term_sent = false;
  double kill_deadline = 0.0;
  int status = 0;
  for (;;) {
    if (g_term_requested && !term_sent) {
      // a kill-time override (record_dir/grace, written by the agent
      // just before SIGTERM) wins over the launch-time --grace: a pod
      // replace may want a longer drain than the spec default, and an
      // operator kill a shorter one
      FILE* gf = fopen((record_dir + "/grace").c_str(), "r");
      if (gf) {
        double v = 0.0;
        if (fscanf(gf, "%lf", &v) == 1 && v >= 0.0) grace_s = v;
        fclose(gf);
      }
      kill(-child, SIGTERM);
      term_sent = true;
      kill_deadline = now_s() + grace_s;
    }
    if (term_sent && now_s() >= kill_deadline) {
      kill(-child, SIGKILL);
      kill_deadline = now_s() + 3600;  // once is enough
    }
    pid_t done = waitpid(child, &status, WNOHANG);
    if (done == child) break;
    if (done < 0 && errno != EINTR) break;
    struct timespec nap = {0, 50 * 1000 * 1000};  // 50ms
    nanosleep(&nap, nullptr);
  }

  int code = 0;
  if (WIFEXITED(status)) {
    code = WEXITSTATUS(status);
  } else if (WIFSIGNALED(status)) {
    code = 128 + WTERMSIG(status);
  }
  write_file(record_dir + "/exit_status", std::to_string(code) + "\n");
  return code;
}
